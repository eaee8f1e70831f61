"""The batched SELL execution core on Hopper: multi-RHS SpMM + row scatter,
and the bucket loop of the graph kernels.

Port of the resident schedule of ``repro.kernels.sell_core`` (and of
``repro.kernels.sell.spmv_sell``, its k = 1 column).  k right-hand sides
against one matrix fill the RHS lanes that a single request leaves idle —
the paper's latency-tolerance argument applied across requests — so a
whole coalesced request group runs as ONE launch set: one kernel launch
per width bucket.

* :func:`spmm_sell` — the wrapper.  On CUDA tensors it launches the
  hand-written kernel ``csrc/spmm_sell.cu`` (kernel B1) once per bucket,
  or raises; there is no fallback.  On CPU tensors it runs
  :func:`spmm_sell_ref`, and only then.
* :func:`spmm_sell_ref` — the plain PyTorch version of the same function,
  for the CPU tests and for holding the kernel against on the card.

* :func:`spmm_sell_stream` — the same function on the streaming schedule
  (the reference's out-of-VMEM ``spmm_sell_stream``): on CUDA tensors one
  launch of ``csrc/spmm_sell_stream.cu`` (kernel B2) per bucket, which
  stages through shared memory the rows of X each block's rows touch
  (a :class:`~repro_torch.sparse.formats.StreamColumnMap`); on CPU tensors
  :func:`spmm_sell_stream_ref`, the TPU kernel's column-tile schedule in
  plain PyTorch.  B2 is bit-equal to B1 on every bucket B1 walks with one
  thread a row (the same multiply-adds in the same order; on a bucket B1
  splits across threads the two agree to rounding), and the plain B2 to
  the plain B1 where each row's columns ascend; elsewhere the TPU
  schedule's order of additions differs, and the two agree to rounding.

* :func:`bucketed_node_step` — the graph kernels' bucket loop (the
  counterpart of the reference's ``bucketed_node_step``): one launch of
  kernel B3 per non-empty width bucket, the combine (BFS or PageRank)
  chosen by the caller's launch function, the scatter to node order fused
  into the kernel.  :func:`neighbour_chunks` is the gather the plain
  versions of those kernels share.

Both keep the reference's contract: every real row appears in exactly one
bucket, padding lanes scatter into a dump row (index ``n_rows``) of an
``(n_rows + 1, k_pad)`` buffer that is trimmed to ``(n_rows, k)``, and the
k axis is padded at most once (:func:`k_tile_for` / :func:`padded_k`): a
power-of-two k is never re-padded.  Never scatter with ``accumulate=True``:
pad lanes hit the dump row many times.
"""
from __future__ import annotations

import torch

from repro_torch.analysis.preflight import (
    stream_bucket_rows,
    stream_chunk_rows,
    stream_col_tile,
)
from repro_torch.core.autotune import (
    KERNEL_DTYPES,
    MAX_K_TILE,
    pick_stream_tiles,
    spmm_split,
)
from repro_torch.sparse.formats import (
    PAD,
    StreamColumnMap,
    pow2_ceil,
    stream_column_map,
)

__all__ = [
    "KERNEL_LAUNCHES",
    "PAD",
    "STREAM_LAUNCHES",
    "bucketed_node_step",
    "graph_storage",
    "k_tile_for",
    "neighbour_chunks",
    "node_k_tile",
    "padded_k",
    "pow2_ceil",
    "spmm_sell",
    "spmm_sell_ref",
    "spmm_sell_stream",
    "spmm_sell_stream_ref",
    "spmv_sell",
    "splits",
]

#: Launches of kernel B1 by :func:`spmm_sell` in this process: one per
#: bucket of every call on CUDA tensors, counted where the kernel is
#: launched and nowhere else (a run shows its main path went through it).
KERNEL_LAUNCHES = 0
#: Launches of kernel B2 by :func:`spmm_sell_stream`, counted the same way.
STREAM_LAUNCHES = 0

_KERNEL_DTYPES = tuple(getattr(torch, d) for d in KERNEL_DTYPES)


# ---------------------------------------------------------------------------
# The one RHS padding policy (copied from the reference)
# ---------------------------------------------------------------------------


def k_tile_for(k: int, k_block: int) -> int:
    """The RHS tile one thread carries: ``min(k_block, pow2_ceil(k))``.

    Both powers of two, so the tile always divides ``pow2_ceil(k)`` — the
    single-padding guarantee: a caller that pow2-pads its stack (the
    service's ``_pow2_pad``) hands the core a k it never pads again.
    """
    return min(max(int(k_block), 1), pow2_ceil(max(int(k), 1)))


def padded_k(k: int, k_block: int) -> int:
    """The k the core actually runs: ``k`` rounded up to the k tile;
    ``padded_k(pow2, k_block) == pow2`` for every pow2/k_block pair."""
    kp = k_tile_for(k, k_block)
    return kp * -(-max(int(k), 1) // kp)


# ---------------------------------------------------------------------------
# Argument contract (checked on every device, so the CPU tests reach it)
# ---------------------------------------------------------------------------


def _check_args(bucket_cols, bucket_vals, bucket_rows, x, n_rows: int) -> None:
    """Device, dtype, shape and contiguity of one launch set.  The kernel
    computes raw offsets from these shapes, so a mismatch must raise here.
    Column-index bounds are the preflight's job (a host scan at
    registration, :func:`repro_torch.analysis.preflight.plan_spmm_sell`)."""
    if not (len(bucket_cols) == len(bucket_vals) == len(bucket_rows)):
        raise ValueError("need one cols/vals/rows tensor per bucket")
    if x.ndim != 2:
        raise ValueError(f"X must be (n_cols, k), got shape {tuple(x.shape)}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"X dtype {x.dtype} is not float32 or float64")
    if n_rows < 0:
        raise ValueError(f"n_rows must be >= 0, got {n_rows}")
    for b, (cols, vals, rows) in enumerate(
            zip(bucket_cols, bucket_vals, bucket_rows)):
        for name, t in (("cols", cols), ("vals", vals), ("rows", rows)):
            if t.device != x.device:
                raise ValueError(
                    f"bucket {b} {name} on {t.device}, X on {x.device}")
            if not t.is_contiguous():
                raise ValueError(f"bucket {b} {name} is not contiguous")
        if cols.dtype != torch.int32 or rows.dtype != torch.int32:
            raise TypeError(f"bucket {b}: cols/rows must be int32")
        if vals.dtype != x.dtype:
            raise TypeError(
                f"bucket {b}: value dtype {vals.dtype} != X dtype {x.dtype}")
        if cols.ndim != 3 or vals.shape != cols.shape:
            raise ValueError(
                f"bucket {b}: cols {tuple(cols.shape)} / vals "
                f"{tuple(vals.shape)} are not one (S, W, C) slab")
        if tuple(rows.shape) != (cols.shape[0], cols.shape[2]):
            raise ValueError(
                f"bucket {b}: rows {tuple(rows.shape)} != (S, C) "
                f"{(cols.shape[0], cols.shape[2])}")


# ---------------------------------------------------------------------------
# Multi-RHS SpMM
# ---------------------------------------------------------------------------


def spmm_sell_ref(bucket_cols, bucket_vals, bucket_rows, x: torch.Tensor, *,
                  n_rows: int) -> torch.Tensor:
    """Y = A @ X over width-bucketed SELL slabs, in plain PyTorch.

    The kernel's arithmetic in its order: per bucket, every (slice, lane)
    row accumulates ``vals[s, w, c] * X[cols[s, w, c]]`` over w = 0 .. W-1,
    PAD entries contributing exactly zero; rows scatter into an
    ``(n_rows + 1, k)`` buffer whose dump row takes the padding lanes.
    Runs on whatever device its tensors are on.
    """
    _check_args(bucket_cols, bucket_vals, bucket_rows, x, n_rows)
    k = x.shape[1]
    y = torch.zeros((n_rows + 1, k), dtype=x.dtype, device=x.device)
    for cols, vals, rows in zip(bucket_cols, bucket_vals, bucket_rows):
        n_slices, width, c = cols.shape
        acc = torch.zeros((n_slices, c, k), dtype=x.dtype, device=x.device)
        for w in range(width):
            col = cols[:, w, :]
            mask = col != PAD
            gathered = x[torch.where(mask, col, 0).long()]    # (S, C, k)
            acc += torch.where(mask[..., None],
                               vals[:, w, :, None] * gathered, 0)
        y[rows.reshape(-1).long()] = acc.reshape(n_slices * c, k)
    return y[:n_rows]


def splits(bucket_cols) -> bool:
    """Whether kernel B1 splits any of these (S, W, C) buckets across
    threads (:func:`repro_torch.core.autotune.spmm_split`; whether it
    splits depends on the bucket's shape only, not on the RHS tile)."""
    return any(spmm_split(c.shape[1], c.shape[2], c.shape[0]).parts > 1
               for c in bucket_cols)


def _launch_bucket(cols, vals, rows, x, y, k_tile: int) -> None:
    """One launch of kernel B1 on PyTorch's current stream of X's device,
    made with that device current, walking the bucket as
    :func:`repro_torch.core.autotune.spmm_split` chooses."""
    global KERNEL_LAUNCHES
    from repro_torch.kernels import cuda_lib

    lib = cuda_lib.library("spmm_sell")
    n_slices, width, c = cols.shape
    split = spmm_split(width, c, n_slices, k_tile, x.element_size())
    with torch.cuda.device(x.device):
        err = lib.repro_spmm_sell_bucket(
            cols.data_ptr(), vals.data_ptr(), rows.data_ptr(), x.data_ptr(),
            y.data_ptr(), n_slices, width, c, x.shape[1], k_tile,
            split.threads, split.parts, int(x.dtype == torch.float64),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(
            f"spmm_sell kernel launch failed (cudaError {err}: {msg}) for a "
            f"({n_slices}, {width}, {c}) bucket, k_tile={k_tile}, "
            f"{split.parts} threads a row")
    KERNEL_LAUNCHES += 1


def spmm_sell(bucket_cols, bucket_vals, bucket_rows, x: torch.Tensor, *,
              n_rows: int, k_block: int = 8) -> torch.Tensor:
    """Y = A @ X over width-bucketed SELL slabs; X is (n_cols, k).

    Returns Y of shape (n_rows, k) on X's device.  The k axis is padded to
    the tile one thread carries (:func:`k_tile_for`) at most once.  On a
    CUDA device every bucket is one launch of kernel B1; on the CPU the
    plain :func:`spmm_sell_ref` runs instead.  Unlike the reference there
    is no ``w_block``: one thread walks a row's whole bucket width, or, in
    the buckets :func:`repro_torch.core.autotune.spmm_split` splits,
    ``parts`` threads share it and their sums are added in a fixed order
    (deterministic; within the tolerance of the plain version, not
    bit-equal to it or to B2 there).
    """
    _check_args(bucket_cols, bucket_vals, bucket_rows, x, n_rows)
    if x.device.type == "cpu":
        return spmm_sell_ref(bucket_cols, bucket_vals, bucket_rows, x,
                             n_rows=n_rows)
    if x.device.type != "cuda":
        raise RuntimeError(
            f"spmm_sell has a CUDA kernel and a CPU reference; got {x.device}")
    k = x.shape[1]
    kt = k_tile_for(k, k_block)
    if k % kt:
        x = torch.nn.functional.pad(x, (0, kt - k % kt))
    x = x.contiguous()
    if x.data_ptr() % 16:                       # the kernel's 16 B X loads
        x = x.clone()
    y = torch.zeros((n_rows + 1, x.shape[1]), dtype=x.dtype, device=x.device)
    for cols, vals, rows in zip(bucket_cols, bucket_vals, bucket_rows):
        _launch_bucket(cols, vals, rows, x, y, kt)
    return y[:n_rows, :k]


def spmv_sell(bucket_cols, bucket_vals, bucket_rows, x: torch.Tensor, *,
              n_rows: int) -> torch.Tensor:
    """y = A @ x over width-bucketed SELL slabs; the k = 1 column of
    :func:`spmm_sell`.  Returns y of shape (n_rows,)."""
    return spmm_sell(bucket_cols, bucket_vals, bucket_rows, x[:, None],
                     n_rows=n_rows, k_block=1)[:, 0]


# ---------------------------------------------------------------------------
# Streaming schedule (kernel B2)
# ---------------------------------------------------------------------------


def spmm_sell_stream_ref(bucket_cols, bucket_vals, bucket_rows,
                         x: torch.Tensor, *, n_rows: int,
                         col_tile: int) -> torch.Tensor:
    """Y = A @ X over width-bucketed SELL slabs on the streaming schedule,
    in plain PyTorch.

    The TPU kernel's order of additions: for each column tile in turn, each
    (slice, lane) row adds ``vals * X[col]`` for its entries whose column
    lies in the tile, w ascending (entries outside the tile add an exact
    zero there, which changes no sum).  Computed by visiting each row's
    entries grouped by tile — a stable sort of the w axis by tile index,
    PAD last — and running :func:`spmm_sell_ref` over that order.  On rows
    whose columns ascend, the order is w's own, so the result is bit-equal
    to :func:`spmm_sell_ref`.  Runs on whatever device its tensors are on.
    """
    _check_args(bucket_cols, bucket_vals, bucket_rows, x, n_rows)
    ct = stream_col_tile(col_tile, x.shape[0])
    last = x.shape[0] // ct + 1                 # past every tile: PAD's key
    order = [torch.sort(torch.where(cols == PAD, last, cols.long() // ct),
                        dim=1, stable=True).indices
             for cols in bucket_cols]
    return spmm_sell_ref(
        tuple(torch.gather(c, 1, o) for c, o in zip(bucket_cols, order)),
        tuple(torch.gather(v, 1, o) for v, o in zip(bucket_vals, order)),
        bucket_rows, x, n_rows=n_rows)


def _check_column_map(column_map, bucket_cols, block_rows, device) -> None:
    """The block column lists a B2 launch set reads: built for these block
    rows and these slabs (``lcols`` shaped like each bucket's ``cols``), on
    X's device.  The map's own consistency (dtypes, contiguity, sizes) was
    checked when it was made (:class:`~repro_torch.sparse.formats
    .StreamColumnMap`); its index bounds are the preflight's job
    (:class:`repro_torch.analysis.preflight.StreamMapMeta`)."""
    if tuple(column_map.block_rows) != tuple(block_rows):
        raise ValueError(
            f"column map built for block rows {tuple(column_map.block_rows)}"
            f", the launch takes {tuple(block_rows)}")
    if bucket_cols and column_map.device != device:
        raise ValueError(f"column map on {column_map.device}, X on {device}")
    for b, (cols, lcols) in enumerate(zip(bucket_cols, column_map.lcols)):
        if lcols.shape != cols.shape:
            raise ValueError(
                f"bucket {b} column map lcols {tuple(lcols.shape)} != cols "
                f"{tuple(cols.shape)}")


def _launch_stream_bucket(lcols, vals, rows, lane_end, block_ptr, block_cols,
                          x, y, k_tile: int, chunk_rows: int,
                          block_rows: int, stream: int) -> None:
    """One launch of kernel B2 on ``stream`` (a raw CUDA stream of X's
    device, which the caller makes current): blocks of ``block_rows``
    rows, each staging its column list ``chunk_rows`` X rows at a time."""
    global STREAM_LAUNCHES
    from repro_torch.kernels import cuda_lib

    lib = cuda_lib.library("spmm_sell_stream")
    n_slices, width, c = lcols.shape
    err = lib.repro_spmm_sell_stream_bucket(
        lcols.data_ptr(), vals.data_ptr(), rows.data_ptr(),
        lane_end.data_ptr(), block_ptr.data_ptr(), block_cols.data_ptr(),
        x.data_ptr(), y.data_ptr(), n_slices, width, c, x.shape[1], k_tile,
        chunk_rows, block_rows, int(x.dtype == torch.float64), stream)
    if err != 0:
        msg = lib.repro_stream_cuda_error_string(err).decode()
        raise RuntimeError(
            f"spmm_sell_stream kernel launch failed (cudaError {err}: {msg}) "
            f"for a ({n_slices}, {width}, {c}) bucket, k_tile={k_tile}, "
            f"chunk_rows={chunk_rows}, block_rows={block_rows}")
    STREAM_LAUNCHES += 1


def spmm_sell_stream(bucket_cols, bucket_vals, bucket_rows, x: torch.Tensor,
                     *, n_rows: int, k_block: int = 8,
                     col_tile: int | None = None,
                     row_tile: int | None = None,
                     column_map: StreamColumnMap | None = None
                     ) -> torch.Tensor:
    """Y = A @ X over width-bucketed SELL slabs on the streaming schedule;
    the contract and the result of :func:`spmm_sell`.

    ``col_tile`` (the most X rows a staged chunk holds) and ``row_tile``
    (slices a block holds) default to :func:`repro_torch.core.autotune
    .pick_stream_tiles` at the k tile that runs.  The k axis is padded once,
    as in :func:`spmm_sell`; ``col_tile`` is coerced to a power of two and
    clamped at ``pow2_ceil(n_cols)`` (:func:`stream_col_tile`), and each
    bucket's block rows come from :func:`stream_bucket_rows`.  On a CUDA
    device every bucket is one launch of kernel B2, which reads the
    block column lists of ``column_map`` (a
    :class:`~repro_torch.sparse.formats.StreamColumnMap` on X's device for
    those block rows; ``ops`` builds it once per operand).  Without one the
    wrapper builds it here, from a host copy of ``bucket_cols``, on every
    call.  B2 is bit-equal to :func:`spmm_sell` on the same tensors
    wherever B1 walks a bucket with one thread a row; on the CPU the plain
    :func:`spmm_sell_stream_ref` runs instead (no map needed).
    """
    _check_args(bucket_cols, bucket_vals, bucket_rows, x, n_rows)
    k = x.shape[1]
    kt = k_tile_for(k, k_block)
    c = bucket_cols[0].shape[2] if bucket_cols else 1
    picked = pick_stream_tiles(c, kt, x.element_size())
    ct = stream_col_tile(picked[0] if col_tile is None else col_tile,
                         x.shape[0])
    rt = picked[1] if row_tile is None else max(int(row_tile), 1)
    if x.device.type == "cpu":
        return spmm_sell_stream_ref(bucket_cols, bucket_vals, bucket_rows, x,
                                    n_rows=n_rows, col_tile=ct)
    if x.device.type != "cuda":
        raise RuntimeError(
            f"spmm_sell_stream has a CUDA kernel and a CPU reference; got "
            f"{x.device}")
    block_rows = stream_bucket_rows(rt, [t.shape for t in bucket_cols])
    if column_map is None:
        column_map = stream_column_map(
            tuple(t.cpu().numpy() for t in bucket_cols), block_rows
        ).to_device(x.device)
    _check_column_map(column_map, bucket_cols, block_rows, x.device)
    if k % kt:
        x = torch.nn.functional.pad(x, (0, kt - k % kt))
    x = x.contiguous()
    if x.data_ptr() % 16:                       # the kernel's 16 B row copies
        x = x.clone()
    # zeros, as B1's: a row no bucket names (slabs adopted through
    # slabs_from_arrays, or a subset of buckets) reads 0
    y = torch.zeros((n_rows + 1, x.shape[1]), dtype=x.dtype, device=x.device)
    with torch.cuda.device(x.device):
        stream = torch.cuda.current_stream().cuda_stream
        for b, (vals, rows) in enumerate(zip(bucket_vals, bucket_rows)):
            _launch_stream_bucket(
                column_map.lcols[b], vals, rows, column_map.lane_end[b],
                column_map.block_ptr[b], column_map.block_cols[b], x, y, kt,
                stream_chunk_rows(ct, column_map.longest[b]), block_rows[b],
                stream)
    return y[:n_rows, :k]


# ---------------------------------------------------------------------------
# Shared bucket-launch loop for the graph kernels (kernel B3)
# ---------------------------------------------------------------------------

#: Elements of one gathered (rows, w-chunk[, k]) block in the plain graph
#: steps: a whole (S, C, W, k) gather at k = 32 on a 2M-node graph would
#: take ~13 GB, so the plain versions walk the neighbour axis in chunks.
PLAIN_GATHER_ELEMS = 1 << 25


def node_k_tile(k: int) -> int:
    """State columns one thread of a graph kernel carries: the largest
    power of two dividing ``k``, capped at ``MAX_K_TILE``.  ``k`` is then
    always a whole number of tiles, so the state is never padded."""
    k = max(int(k), 1)
    return min(k & -k, MAX_K_TILE)


def graph_storage(adj: torch.Tensor) -> torch.Tensor:
    """``adj`` with its last two axes swapped in memory, as a view of the
    same shape: the storage the graph kernels read ((S, W, C) for a
    (S, C, W) SELL bucket, (width, n) for an (n, width) ELLPACK
    adjacency).  Free for the uploads of
    :meth:`repro_torch.graphs.SellGraphSlabs.to_device` and
    :meth:`repro_torch.graphs.EllpackGraph.to_device`; a copy otherwise."""
    return adj.transpose(-1, -2).contiguous().transpose(-1, -2)


def check_graph_args(bucket_adj, bucket_nodes, state: torch.Tensor) -> None:
    """Device, dtype, shape and contiguity of one graph step over SELL
    buckets.  Neighbour-id and node-map bounds are the preflight's job
    (:func:`repro_torch.analysis.preflight.plan_bfs_sell`)."""
    if len(bucket_adj) != len(bucket_nodes):
        raise ValueError("need one adjacency and one node map per bucket")
    if state.ndim not in (1, 2):
        raise ValueError(
            f"state must be (n + 1,) or (n + 1, k), got {tuple(state.shape)}")
    for b, (adj, nodes) in enumerate(zip(bucket_adj, bucket_nodes)):
        for name, t in (("adj", adj), ("nodes", nodes)):
            if t.device != state.device:
                raise ValueError(
                    f"bucket {b} {name} on {t.device}, state on {state.device}")
            if t.dtype != torch.int32:
                raise TypeError(f"bucket {b} {name} must be int32, got {t.dtype}")
        if adj.ndim != 3 or tuple(nodes.shape) != tuple(adj.shape[:2]):
            raise ValueError(
                f"bucket {b}: adj {tuple(adj.shape)} / nodes "
                f"{tuple(nodes.shape)} are not one (S, C, W) slab and its "
                "(S, C) node map")
        if not nodes.is_contiguous():
            raise ValueError(f"bucket {b} nodes is not contiguous")


def neighbour_chunks(adj: torch.Tensor, state: torch.Tensor):
    """Yield ``(mask, gathered)`` over chunks of the last (neighbour) axis
    of ``adj`` ((S, C, W) or (n, W)): ``gathered[..., j] = state[adj[...,
    j]]`` with a trailing state-column axis when ``state`` is 2-D, and
    ``mask`` marks the real neighbours (PAD slots gather row 0 and must be
    masked by the caller).  The gather the plain graph steps share."""
    width = adj.shape[-1]
    rows = adj.numel() // max(width, 1)
    k = state.shape[1] if state.ndim == 2 else 1
    step = max(1, PLAIN_GATHER_ELEMS // max(1, rows * k))
    for w0 in range(0, width, step):
        a = adj[..., w0:w0 + step]
        mask = a != PAD
        gathered = state[torch.where(mask, a, 0).long()]
        yield (mask[..., None] if state.ndim == 2 else mask), gathered


def bucketed_node_step(launch, bucket_adj, bucket_nodes,
                       state: torch.Tensor) -> None:
    """Launch one graph kernel per non-empty width bucket on the card.

    ``launch(adj, nodes, k_tile)`` makes one launch of the caller's combine
    (BFS or PageRank, kernel B3) over one bucket: ``adj`` is the bucket's
    (S, W, C) storage, ``nodes`` its (S, C) node map, ``k_tile`` the state
    columns one thread carries (:func:`node_k_tile`).  The kernel reads
    ``state`` and scatters each node's new value into the caller's output
    through ``nodes``; padding lanes (node id n) write nothing.  An empty
    bucket is skipped: the kernel's C entry refuses zero slices.  Launches
    are made with ``state``'s device current, on its current stream.
    """
    check_graph_args(bucket_adj, bucket_nodes, state)
    k_tile = node_k_tile(state.shape[1] if state.ndim == 2 else 1)
    with torch.cuda.device(state.device):
        for adj, nodes in zip(bucket_adj, bucket_nodes):
            if adj.shape[0] == 0:
                continue
            launch(adj.transpose(1, 2).contiguous(), nodes, k_tile)
