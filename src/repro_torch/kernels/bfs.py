"""BFS on Hopper: bottom-up level steps over ELLPACK and SELL adjacency.

Port of ``repro.kernels.bfs``.  One level is gather-only ("bottom-up"): a
node joins the frontier when its distance is still INF and any of its
in-neighbours sits on the previous level.  Two layouts, one CUDA source
(``csrc/graph_step.cu``):

* :func:`bfs_step` — one level over an ELLPACK in-adjacency ``(n, width)``,
  kernel B4: a frontier pass (``repro_bfs_frontier``, the bitmap of the
  previous level, :func:`bfs_frontier`) and the walk (``repro_bfs_ell_step``,
  each warp's nodes up to its live width, :func:`ell_live_widths`);
  :func:`bfs` drives it to the fixed point from one source.
* :func:`bfs_step_sell` — one level over width-bucketed, in-degree-sorted
  SELL slabs, kernel B3 with the BFS combine (``repro_bfs_sell_bucket``,
  one launch per bucket through
  :func:`repro_torch.kernels.sell_core.bucketed_node_step`);
  :func:`bfs_sell` drives it.  The state is ``(n + 1,)`` for one source and
  ``(n + 1, k)`` for k stacked sources, one column each, all advanced by
  one launch set per level; the dump slot ``n`` stays INF.

On CUDA tensors the steps launch their kernel or raise; on CPU tensors,
and only there, they run their plain PyTorch versions
(:func:`bfs_step_ref`, :func:`bfs_frontier_ref`,
:func:`bfs_step_sell_ref`), which the chip smoke run also holds the
kernels against on the card.  The host loop stops when
a level changes nothing: ``torch.equal`` is one device sync per level.
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.autotune import ELL_NODE_BLOCK_THREADS, WARP, node_split
from repro_torch.graphs.gen import INF, PAD
from repro_torch.kernels import sell_core, spmv

__all__ = [
    "INF",
    "KERNEL_LAUNCHES",
    "PAD",
    "bfs",
    "bfs_frontier",
    "bfs_frontier_ref",
    "bfs_ref",
    "bfs_sell",
    "bfs_sell_ref",
    "bfs_step",
    "bfs_step_ref",
    "bfs_step_sell",
    "bfs_step_sell_ref",
    "cut_to_live",
    "ell_live_widths",
    "level_sync",
]

#: Launches of the BFS kernels in this process, counted where each kernel
#: is launched and nowhere else: ``bfs_step_sell`` (B3, one per non-empty
#: bucket per level), ``bfs_step`` (B4's walk, one per level) and
#: ``bfs_frontier`` (B4's frontier pass, one per level and per
#: :func:`bfs_frontier` call).
KERNEL_LAUNCHES = {"bfs_step_sell": 0, "bfs_step": 0, "bfs_frontier": 0}


def _level(level) -> int:
    """The level as a host int (the reference passes a (1,) array)."""
    if isinstance(level, torch.Tensor):
        return int(level.reshape(-1)[0])
    return int(np.asarray(level).reshape(-1)[0])


def _check_dist(dist: torch.Tensor) -> None:
    if dist.dtype != torch.int32:
        raise TypeError(f"BFS distances must be int32, got {dist.dtype}")


def _require_cuda(t: torch.Tensor, what: str) -> None:
    if t.device.type != "cuda":
        raise RuntimeError(
            f"{what} has a CUDA kernel and a CPU reference; got {t.device}")


def _graph_lib():
    from repro_torch.kernels import cuda_lib

    return cuda_lib.library("graph_step")


def _raise_on(err: int, lib, what: str) -> None:
    if err != 0:
        msg = lib.repro_graph_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed (cudaError {err}: {msg})")


# ---------------------------------------------------------------------------
# ELLPACK: kernel B4
# ---------------------------------------------------------------------------


def bfs_step_ref(adj: torch.Tensor, dist: torch.Tensor, level, *,
                 vl: int = 256) -> torch.Tensor:
    """One bottom-up level over an ELLPACK in-adjacency, in plain PyTorch
    (``vl`` is the reference's node block; it does not change the result)."""
    level = _level(level)
    _check_dist(dist)
    hit = torch.zeros(dist.shape, dtype=torch.bool, device=dist.device)
    for mask, nd in sell_core.neighbour_chunks(adj, dist):
        hit |= (mask & (nd == level - 1)).any(dim=1)
    return dist.masked_fill((dist == INF) & hit, level)


def ell_live_widths(adj: torch.Tensor) -> torch.Tensor:
    """Each warp's live width of an ELLPACK adjacency ``(n, width)``:
    entry i is 1 + the last slot at which any of the nodes ``32 i .. 32 i
    + 31`` stores a neighbour, 0 if none does (PAD may stand anywhere in a
    row).  Kernel B6's :func:`repro_torch.kernels.spmv.live_widths` of the
    ``(width, n)`` storage viewed as one ``(1, width, n)`` slab, computed
    on ``adj``'s device; int32 of shape (ceil(n / 32),)."""
    return spmv.live_widths(adj.t().contiguous()[None])


def _check_live(adj: torch.Tensor, live: torch.Tensor) -> None:
    """The live-width array of an ``(n, width)`` adjacency: dtype, shape,
    device and contiguity.  Its values may be anything: the walk bounds
    each to ``[0, width]`` (:func:`cut_to_live`)."""
    spmv._check_live(adj.t()[None], live)


def cut_to_live(adj: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """An ``(n, width)`` adjacency with every slot past its warp's live
    width (bounded to ``[0, width]``) set to PAD: what B4 / B5's walk
    reads, :func:`repro_torch.kernels.spmv.cut_to_live` of the ``(1,
    width, n)`` view, laid out as ``adj`` is (so a plain step sums in the
    same order)."""
    cut = spmv.cut_to_live(adj.t()[None], live)[0].t()
    return cut if adj.t().is_contiguous() else cut.contiguous()


def bfs_frontier_ref(dist: torch.Tensor, level) -> torch.Tensor:
    """The frontier bitmap of a BFS level in plain PyTorch: word i of the
    (ceil(n / 32),) int32 result has bit j set where ``dist[32 i + j] ==
    level - 1``."""
    level = _level(level)
    _check_dist(dist)
    n = dist.shape[0]
    on = (dist == level - 1).to(torch.int64)
    on = torch.cat([on, on.new_zeros(-n % WARP)]).view(-1, WARP)
    words = (on << torch.arange(WARP, device=dist.device)).sum(dim=1)
    return torch.where(words >= 1 << 31, words - (1 << 32),
                       words).to(torch.int32)


def _launch_frontier(lib, stream: int, dist: torch.Tensor,
                     frontier: torch.Tensor, level: int) -> None:
    """One launch of B4's frontier pass on ``stream``, the current stream
    of ``dist``'s device (which the caller makes current)."""
    n = dist.shape[0]
    err = lib.repro_bfs_frontier(dist.data_ptr(), frontier.data_ptr(), level,
                                 n, ELL_NODE_BLOCK_THREADS, stream)
    _raise_on(err, lib, f"bfs_frontier ({n} nodes)")
    KERNEL_LAUNCHES["bfs_frontier"] += 1


def _frontier_words(dist: torch.Tensor) -> torch.Tensor:
    return torch.empty(-(-dist.shape[0] // WARP), dtype=torch.int32,
                       device=dist.device)


def bfs_frontier(dist: torch.Tensor, level) -> torch.Tensor:
    """The frontier bitmap of a BFS level (:func:`bfs_frontier_ref`'s
    function): on the card one launch of B4's frontier pass, a
    ``__ballot_sync`` a warp of 32 nodes; on the CPU the plain version."""
    level = _level(level)
    _check_dist(dist)
    if dist.ndim != 1:
        raise ValueError(f"dist must be (n,), got {tuple(dist.shape)}")
    if dist.device.type == "cpu":
        return bfs_frontier_ref(dist, level)
    _require_cuda(dist, "bfs_frontier")
    dist = dist.contiguous()
    frontier = _frontier_words(dist)
    if dist.shape[0]:
        lib = _graph_lib()
        with torch.cuda.device(dist.device):
            _launch_frontier(lib, torch.cuda.current_stream().cuda_stream,
                             dist, frontier, level)
    return frontier


def _launch_ell(lib, stream: int, adj: torch.Tensor, live: torch.Tensor,
                frontier: torch.Tensor, dist: torch.Tensor, out: torch.Tensor,
                level: int) -> None:
    """One launch of B4's walk on ``stream`` (as :func:`_launch_frontier`);
    ``adj`` is the (width, n) storage."""
    width, n = adj.shape
    err = lib.repro_bfs_ell_step(
        adj.data_ptr(), live.data_ptr(), frontier.data_ptr(),
        dist.data_ptr(), out.data_ptr(), level, n, width,
        ELL_NODE_BLOCK_THREADS, stream)
    _raise_on(err, lib, f"bfs_step ({n} nodes, width {width})")
    KERNEL_LAUNCHES["bfs_step"] += 1


def bfs_step(adj: torch.Tensor, dist: torch.Tensor, level, *,
             vl: int = 256,
             live_width: torch.Tensor | None = None) -> torch.Tensor:
    """One bottom-up BFS level over ELLPACK adjacency (n, width).

    ``level`` is an int (or the reference's (1,) array); returns the
    updated (n,) distances as a new tensor.  On the card two launches of
    kernel B4: the frontier pass packs ``dist == level - 1`` into a bitmap
    (:func:`bfs_frontier`), then one thread a node still at INF walks its
    in-neighbours up to its warp's live width, several ids loaded before
    their bits are tested, and stops at the first round with a hit; a
    node not at INF keeps its distance.  ``live_width`` is the
    adjacency's :func:`ell_live_widths` on the same device (``ops``
    caches it once per graph); without it the step computes it, a pass
    over ``adj`` each call.  The walk bounds each width to ``[0, width]``:
    a width past the last neighbour walks as far as the true one (the
    slots past it are PAD), a negative one walks no slot (the warp's nodes
    at INF stay there); the CPU path walks the same slots
    (:func:`cut_to_live`).  ``vl`` is the
    reference's node block and does not shape the launch.  ``adj`` stored
    as (width, n) (an :meth:`~repro_torch.graphs.EllpackGraph.to_device`
    upload) is read in place; any other storage is copied to it first.
    """
    level = _level(level)
    _check_dist(dist)
    if adj.ndim != 2 or dist.shape != (adj.shape[0],):
        raise ValueError(f"adj {tuple(adj.shape)} / dist {tuple(dist.shape)}"
                         " are not (n, width) / (n,)")
    if adj.dtype != torch.int32 or adj.device != dist.device:
        raise TypeError("adj must be int32 on the distances' device")
    if live_width is not None:
        _check_live(adj, live_width)
    if dist.device.type == "cpu":
        if live_width is not None:
            adj = cut_to_live(adj, live_width)
        return bfs_step_ref(adj, dist, level, vl=vl)
    _require_cuda(dist, "bfs_step")
    dist = dist.contiguous()
    out = torch.empty_like(dist)
    if dist.shape[0] == 0:
        return out
    live = ell_live_widths(adj) if live_width is None else live_width
    frontier = _frontier_words(dist)
    store = adj.t().contiguous()
    lib = _graph_lib()
    # both launches back to back: nothing but the walk's own launch between
    with torch.cuda.device(dist.device):
        stream = torch.cuda.current_stream().cuda_stream
        _launch_frontier(lib, stream, dist, frontier, level)
        _launch_ell(lib, stream, store, live, frontier, dist, out, level)
    return out


def _bfs_drive(step, adj, source: int, vl: int, max_levels) -> torch.Tensor:
    n = adj.shape[0]
    if not 0 <= int(source) < n:
        raise ValueError(f"source {source} out of range [0, {n})")
    dist = torch.full((n,), INF, dtype=torch.int32, device=adj.device)
    dist[int(source)] = 0
    for level in range(1, (max_levels or n) + 1):
        new = step(adj, dist, level, vl=vl)
        if torch.equal(new, dist):
            break
        dist = new
    return dist


def bfs(adj: torch.Tensor, source: int, *, vl: int = 256,
        max_levels: int | None = None,
        live_width: torch.Tensor | None = None) -> torch.Tensor:
    """Full BFS: fixed-point iteration of :func:`bfs_step`.

    Runs level-synchronous steps until no distance changes (checked on the
    host, one sync per level) or ``max_levels`` is hit.  The adjacency is
    brought to the kernel's (width, n) storage once, not once per level,
    and on the card its live widths are computed once a drive unless
    ``live_width`` hands them in.
    """
    adj = sell_core.graph_storage(adj)
    if live_width is None and adj.device.type == "cuda":
        live_width = ell_live_widths(adj)
    return _bfs_drive(functools.partial(bfs_step, live_width=live_width),
                      adj, source, vl, max_levels)


def bfs_ref(adj: torch.Tensor, source: int, *, vl: int = 256,
            max_levels: int | None = None) -> torch.Tensor:
    """:func:`bfs` driven by the plain step on any device."""
    return _bfs_drive(bfs_step_ref, sell_core.graph_storage(adj), source, vl,
                      max_levels)


# ---------------------------------------------------------------------------
# SELL: kernel B3 with the BFS combine
# ---------------------------------------------------------------------------


def bfs_step_sell_ref(bucket_adj, bucket_nodes, dist: torch.Tensor,
                      level) -> torch.Tensor:
    """One bottom-up level over SELL buckets, in plain PyTorch: per bucket,
    a node gets ``level`` if its distance is INF and any in-neighbour is at
    ``level - 1``; results scatter to node order, the dump slot stays INF."""
    level = _level(level)
    _check_dist(dist)
    sell_core.check_graph_args(bucket_adj, bucket_nodes, dist)
    out = dist.clone()
    for adj, nodes in zip(bucket_adj, bucket_nodes):
        hit = torch.zeros(tuple(adj.shape[:2]) + tuple(dist.shape[1:]),
                          dtype=torch.bool, device=dist.device)
        for mask, nd in sell_core.neighbour_chunks(adj, dist):
            hit |= (mask & (nd == level - 1)).any(dim=2)
        idx = nodes.reshape(-1).long()
        mine = dist[idx]
        out[idx] = mine.masked_fill((mine == INF) & hit.reshape(mine.shape),
                                    level)
    out[-1] = INF
    return out


def _launch_sell_bucket(adj: torch.Tensor, nodes: torch.Tensor,
                        dist: torch.Tensor, out: torch.Tensor, level: int,
                        k_tile: int) -> None:
    """One launch of kernel B3 with the BFS combine over one bucket; ``adj``
    is the bucket's (S, W, C) storage.  Made on the current stream of the
    current device (:func:`sell_core.bucketed_node_step` sets it)."""
    lib = _graph_lib()
    n_slices, width, c = adj.shape
    ld = dist.shape[1] if dist.ndim == 2 else 1
    split = node_split(width, c, n_slices, k_tile, dist.element_size(),
                       "bfs")
    err = lib.repro_bfs_sell_bucket(
        adj.data_ptr(), nodes.data_ptr(), dist.data_ptr(), out.data_ptr(),
        level, n_slices, width, c, ld, k_tile, dist.shape[0] - 1,
        split.threads, split.parts, torch.cuda.current_stream().cuda_stream)
    _raise_on(err, lib, f"bfs_step_sell ({n_slices}, {c}, {width}) bucket, "
              f"k_tile={k_tile}, {split.group} lanes a node, "
              f"{split.parts} parts")
    KERNEL_LAUNCHES["bfs_step_sell"] += 1


def bfs_step_sell(bucket_adj, bucket_nodes, dist: torch.Tensor,
                  level) -> torch.Tensor:
    """One bottom-up level over width-bucketed, degree-sorted adjacency.

    ``bucket_adj[b]`` is (S, C, W_b) int32, ``bucket_nodes[b]`` (S, C).
    ``dist`` is (n + 1,) for a single source or (n + 1, k) for k stacked
    sources (the dump slot stays INF); returns the updated copy with the
    same shape.  On the card every non-empty bucket is one launch of kernel
    B3 that reads ``dist`` and writes a fresh output, walked as
    :func:`repro_torch.core.autotune.node_split` chooses (lanes across the
    state columns, wide buckets split; exact either way); buckets stored
    (S, W_b, C) (:meth:`~repro_torch.graphs.SellGraphSlabs.to_device`) are
    read in place, others are copied to that storage first.
    """
    level = _level(level)
    _check_dist(dist)
    if dist.device.type == "cpu":
        return bfs_step_sell_ref(bucket_adj, bucket_nodes, dist, level)
    _require_cuda(dist, "bfs_step_sell")
    dist = dist.contiguous()
    if dist.data_ptr() % 16:                    # the kernel's 16 B row loads
        dist = dist.clone()
    out = dist.clone()
    sell_core.bucketed_node_step(
        lambda adj, nodes, kt: _launch_sell_bucket(adj, nodes, dist, out,
                                                   level, kt),
        bucket_adj, bucket_nodes, dist)
    out[-1] = INF
    return out


def level_sync(step, n_nodes: int, source, device,
               max_levels=None) -> torch.Tensor:
    """The level loop of the SELL drives around ``step(dist, level)``,
    which returns the new ``(n + 1[, k])`` distances of one level: the
    state starts INF with 0 at each source (one column per source of a
    sequence) and advances until a level changes nothing (``torch.equal``,
    one sync a level) or ``max_levels`` is hit.  Shared by
    :func:`bfs_sell` and the sharded drive
    (:func:`repro_torch.kernels.sell_shard.bfs_sell_sharded`).  Returns
    (n,) distances for a scalar source, (n, k) for k."""
    scalar = np.ndim(source) == 0
    sources = np.atleast_1d(np.asarray(source, np.int64))
    if sources.size and not (0 <= sources.min() and sources.max() < n_nodes):
        raise ValueError(f"sources {sources.tolist()} out of range "
                         f"[0, {n_nodes})")
    k = len(sources)
    if scalar:                                # single-column fast path
        dist = torch.full((n_nodes + 1,), INF, dtype=torch.int32,
                          device=device)
        dist[int(source)] = 0
    else:
        dist = torch.full((n_nodes + 1, k), INF, dtype=torch.int32,
                          device=device)
        dist[torch.from_numpy(sources).to(device),
             torch.arange(k, device=device)] = 0
    for level in range(1, (max_levels or n_nodes) + 1):
        new = step(dist, level)
        if torch.equal(new, dist):
            break
        dist = new
    return dist[:n_nodes]


def _bfs_sell_drive(step, bucket_adj, bucket_nodes, n_nodes: int, source,
                    max_levels) -> torch.Tensor:
    device = bucket_nodes[0].device if bucket_nodes else torch.device("cpu")
    bucket_adj = tuple(sell_core.graph_storage(a) for a in bucket_adj)
    return level_sync(
        lambda dist, level: step(bucket_adj, bucket_nodes, dist, level),
        n_nodes, source, device, max_levels)


def bfs_sell(bucket_adj, bucket_nodes, n_nodes: int, source, *,
             max_levels: int | None = None) -> torch.Tensor:
    """Full BFS over bucketed SELL adjacency, batched over sources.

    ``source`` may be one node id or a sequence of k ids: the frontiers
    become state columns and every level is one launch set for the whole
    batch.  Returns (n_nodes,) distances for a scalar source, (n_nodes, k)
    — one column per source — for a sequence.  Columns that converge early
    stay fixed while the rest keep expanding.
    """
    return _bfs_sell_drive(bfs_step_sell, bucket_adj, bucket_nodes, n_nodes,
                           source, max_levels)


def bfs_sell_ref(bucket_adj, bucket_nodes, n_nodes: int, source, *,
                 max_levels: int | None = None) -> torch.Tensor:
    """:func:`bfs_sell` driven by the plain step on any device."""
    return _bfs_sell_drive(bfs_step_sell_ref, bucket_adj, bucket_nodes,
                           n_nodes, source, max_levels)
