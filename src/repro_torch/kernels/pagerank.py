"""PageRank on Hopper: pull-style power steps over ELLPACK and SELL reverse
adjacency.

Port of ``repro.kernels.pagerank``.  One power step pulls the contributions
``rank[u] / out_degree[u]`` of every in-neighbour u of a node and writes
``(1 - d) / n + d * (pulled + dangling / n)``.  Two layouts, one CUDA
source (``csrc/graph_step.cu``):

* :func:`pagerank_step` — one step over an ELLPACK reverse adjacency
  ``(n, width)``, kernel B5 (``repro_pagerank_ell_step``: each warp's
  nodes up to its live width, :func:`~repro_torch.kernels.bfs
  .ell_live_widths`);
  :func:`pagerank` drives ``iters`` of them for one configuration.
* :func:`pagerank_step_sell` — one step over width-bucketed,
  in-degree-sorted SELL slabs, kernel B3 with the PageRank combine
  (``repro_pagerank_sell_bucket``, one launch per bucket through
  :func:`repro_torch.kernels.sell_core.bucketed_node_step`);
  :func:`pagerank_sell` drives it.  The iterate is ``(n + 1,)`` for one
  (damping, iters) configuration and ``(n + 1, k)`` for k stacked ones, with
  constants ``(3,)`` or ``(3, k)``; every column freezes at its own
  ``iters`` budget.

The contributions, the dangling mass and the constants are plain torch ops
on the device, as the JAX package computes them outside Pallas too.  Ranks
are float64 by default (the reference's x64 path, :data:`RANK_DTYPE`) or
float32 (its x64-off path): the drives take ``dtype=``, and B3 and B5 have
a form for each.  On CUDA tensors the steps launch
their kernel or raise; on CPU tensors, and only there, they run their plain
PyTorch versions (:func:`pagerank_step_ref`, :func:`pagerank_step_sell_ref`).
"""
from __future__ import annotations

import functools

import numpy as np
import torch

from repro_torch.core.autotune import ELL_NODE_BLOCK_THREADS, node_split
from repro_torch.graphs.gen import PAD
from repro_torch.kernels import sell_core
from repro_torch.kernels.bfs import (
    _check_live,
    _graph_lib,
    _raise_on,
    _require_cuda,
    cut_to_live,
    ell_live_widths,
)

__all__ = [
    "KERNEL_LAUNCHES",
    "PAD",
    "broadcast_configs",
    "pagerank",
    "pagerank_ref",
    "pagerank_sell",
    "pagerank_sell_ref",
    "pagerank_step",
    "pagerank_step_ref",
    "pagerank_step_sell",
    "pagerank_step_sell_ref",
    "power_iteration",
]

#: Launches of the PageRank kernels in this process, counted where each
#: kernel is launched and nowhere else: ``pagerank_step_sell`` (B3, one per
#: non-empty bucket per power step) and ``pagerank_step`` (B5, one per
#: step), their float forms under the same names with ``_fp32``.
KERNEL_LAUNCHES = {"pagerank_step_sell": 0, "pagerank_step": 0,
                   "pagerank_step_sell_fp32": 0, "pagerank_step_fp32": 0}


def _count(kernel: str, dtype: torch.dtype) -> None:
    KERNEL_LAUNCHES[kernel if dtype == torch.float64
                    else f"{kernel}_fp32"] += 1

#: The default rank dtype (the reference's x64 path), and the dtypes the
#: kernels have a form for.
RANK_DTYPE = torch.float64
RANK_DTYPES = (torch.float32, torch.float64)


def _check_state(contrib: torch.Tensor, consts: torch.Tensor) -> None:
    if contrib.dtype not in RANK_DTYPES or consts.dtype != contrib.dtype:
        raise TypeError(
            f"contributions and constants must be one dtype, float32 or "
            f"float64, got {contrib.dtype} / {consts.dtype}")
    want = (3,) if contrib.ndim == 1 else (3, contrib.shape[1])
    if tuple(consts.shape) != want:
        raise ValueError(
            f"consts {tuple(consts.shape)} != {want} for contributions "
            f"{tuple(contrib.shape)}")
    if consts.device != contrib.device:
        raise ValueError(f"consts on {consts.device}, contributions on "
                         f"{contrib.device}")


def _combine(pulled: torch.Tensor, consts: torch.Tensor) -> torch.Tensor:
    """``base + d * (pulled + dangling_term)``; ``pulled`` (..., [k])."""
    return consts[0] + consts[1] * (pulled + consts[2])


# ---------------------------------------------------------------------------
# ELLPACK: kernel B5
# ---------------------------------------------------------------------------


def pagerank_step_ref(radj: torch.Tensor, contrib: torch.Tensor,
                      consts: torch.Tensor, *, vl: int = 256) -> torch.Tensor:
    """One pull step over an ELLPACK reverse adjacency, in plain PyTorch."""
    _check_state(contrib, consts)
    pulled = torch.zeros_like(contrib)
    for mask, g in sell_core.neighbour_chunks(radj, contrib):
        pulled += torch.where(mask, g, 0.0).sum(dim=1)
    return _combine(pulled, consts)


def _launch_ell(radj: torch.Tensor, live: torch.Tensor, contrib: torch.Tensor,
                consts: torch.Tensor, out: torch.Tensor) -> None:
    """One launch of kernel B5; ``radj`` is the (width, n) storage."""
    lib = _graph_lib()
    width, n = radj.shape
    with torch.cuda.device(contrib.device):
        err = lib.repro_pagerank_ell_step(
            radj.data_ptr(), live.data_ptr(), contrib.data_ptr(),
            consts.data_ptr(), out.data_ptr(), n, width,
            ELL_NODE_BLOCK_THREADS, int(contrib.dtype == torch.float64),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, lib, f"pagerank_step ({n} nodes, width {width})")
    _count("pagerank_step", contrib.dtype)


def pagerank_step(radj: torch.Tensor, contrib: torch.Tensor,
                  consts: torch.Tensor, *, vl: int = 256,
                  live_width: torch.Tensor | None = None) -> torch.Tensor:
    """One power-iteration step over ELLPACK reverse adjacency (n, width).

    ``contrib`` is (n,) float64 or float32, ``consts`` = [(1-d)/n, d,
    dangling_mass/n] as a (3,) tensor of its dtype on the same device.  On the card one launch
    of kernel B5: one thread a node walks its in-neighbours up to its
    warp's live width, several ids loaded before their contributions are
    gathered, and adds them in ascending slot order (bit-equal to a
    one-slot walk).  ``live_width`` is the adjacency's
    :func:`~repro_torch.kernels.bfs.ell_live_widths` on the same device
    (``ops`` caches it once per graph); without it the step computes it,
    a pass over ``radj`` each call.  The walk bounds each width to ``[0,
    width]``: a width past the last neighbour walks as far as the true
    one, a negative one walks no slot (the warp's nodes pull nothing); the
    CPU path walks the same slots (:func:`~repro_torch.kernels.bfs
    .cut_to_live`).  ``vl`` is the reference's node block and does not
    shape the launch.
    """
    _check_state(contrib, consts)
    if radj.ndim != 2 or contrib.shape != (radj.shape[0],):
        raise ValueError(f"radj {tuple(radj.shape)} / contrib "
                         f"{tuple(contrib.shape)} are not (n, width) / (n,)")
    if radj.dtype != torch.int32 or radj.device != contrib.device:
        raise TypeError("radj must be int32 on the contributions' device")
    if live_width is not None:
        _check_live(radj, live_width)
    if contrib.device.type == "cpu":
        if live_width is not None:
            radj = cut_to_live(radj, live_width)
        return pagerank_step_ref(radj, contrib, consts, vl=vl)
    _require_cuda(contrib, "pagerank_step")
    contrib, consts = contrib.contiguous(), consts.contiguous()
    out = torch.empty_like(contrib)
    if contrib.shape[0] == 0:
        return out
    live = ell_live_widths(radj) if live_width is None else live_width
    _launch_ell(radj.t().contiguous(), live, contrib, consts, out)
    return out


def _rank_dtype(dtype) -> torch.dtype:
    if dtype not in RANK_DTYPES:
        raise TypeError(f"rank dtype must be float32 or float64, got {dtype}")
    return dtype


def _pagerank_drive(step, radj, out_degree, damping: float, iters: int,
                    vl: int, n_real, dtype) -> torch.Tensor:
    dtype = _rank_dtype(dtype)
    n0 = radj.shape[0]
    n = n_real if n_real is not None else n0
    device = radj.device
    real = torch.arange(n0, device=device) < n
    rank = real.to(dtype) * (1.0 / n)
    deg = out_degree.to(device=device, dtype=dtype)
    head = torch.tensor([(1.0 - damping) / n, damping], dtype=dtype,
                        device=device)
    for _ in range(int(iters)):
        contrib = torch.where(deg > 0, rank / torch.clamp(deg, min=1), 0.0)
        dangling = torch.where(real & (deg == 0), rank, 0.0).sum()
        consts = torch.cat([head, (dangling / n).reshape(1)])
        rank = step(radj, contrib, consts, vl=vl)
    return rank


def pagerank(radj: torch.Tensor, out_degree: torch.Tensor, *,
             damping: float = 0.85, iters: int = 20, vl: int = 256,
             n_real: int | None = None,
             live_width: torch.Tensor | None = None,
             dtype: torch.dtype = RANK_DTYPE) -> torch.Tensor:
    """Full PageRank: ``iters`` power steps over the reverse adjacency.

    ``out_degree`` is the (n,) out-degree vector; ``n_real`` excludes
    padding nodes (rows beyond it) from the rank mass and the dangling sum.
    ``dtype`` is the rank dtype, float64 or float32 (B5's two forms).
    The adjacency is brought to the kernel's (width, n) storage once, not
    once per step, and on the card its live widths are computed once a
    drive unless ``live_width`` hands them in.
    """
    radj = sell_core.graph_storage(radj)
    if live_width is None and radj.device.type == "cuda":
        live_width = ell_live_widths(radj)
    return _pagerank_drive(
        functools.partial(pagerank_step, live_width=live_width), radj,
        out_degree, damping, iters, vl, n_real, dtype)


def pagerank_ref(radj: torch.Tensor, out_degree: torch.Tensor, *,
                 damping: float = 0.85, iters: int = 20, vl: int = 256,
                 n_real: int | None = None,
                 dtype: torch.dtype = RANK_DTYPE) -> torch.Tensor:
    """:func:`pagerank` driven by the plain step on any device."""
    return _pagerank_drive(pagerank_step_ref, sell_core.graph_storage(radj),
                           out_degree, damping, iters, vl, n_real, dtype)


# ---------------------------------------------------------------------------
# SELL: kernel B3 with the PageRank combine
# ---------------------------------------------------------------------------


def pagerank_step_sell_ref(bucket_radj, bucket_nodes, contrib: torch.Tensor,
                           consts: torch.Tensor) -> torch.Tensor:
    """One power step over SELL buckets, in plain PyTorch: per bucket, each
    node pulls the sum of its in-neighbours' contributions; results scatter
    to node order, the dump slot stays 0."""
    _check_state(contrib, consts)
    sell_core.check_graph_args(bucket_radj, bucket_nodes, contrib)
    out = torch.zeros_like(contrib)
    for radj, nodes in zip(bucket_radj, bucket_nodes):
        pulled = torch.zeros(tuple(radj.shape[:2]) + tuple(contrib.shape[1:]),
                             dtype=contrib.dtype, device=contrib.device)
        for mask, g in sell_core.neighbour_chunks(radj, contrib):
            pulled += torch.where(mask, g, 0.0).sum(dim=2)
        res = _combine(pulled, consts)
        out[nodes.reshape(-1).long()] = res.reshape(
            (-1,) + tuple(contrib.shape[1:]))
    out[-1] = 0.0
    return out


def _launch_sell_bucket(radj: torch.Tensor, nodes: torch.Tensor,
                        contrib: torch.Tensor, consts: torch.Tensor,
                        out: torch.Tensor, k_tile: int) -> None:
    """One launch of kernel B3 with the PageRank combine over one bucket;
    ``radj`` is the bucket's (S, W, C) storage.  Made on the current stream
    of the current device (:func:`sell_core.bucketed_node_step` sets it)."""
    lib = _graph_lib()
    n_slices, width, c = radj.shape
    ld = contrib.shape[1] if contrib.ndim == 2 else 1
    split = node_split(width, c, n_slices, k_tile, contrib.element_size(),
                       "pagerank")
    err = lib.repro_pagerank_sell_bucket(
        radj.data_ptr(), nodes.data_ptr(), contrib.data_ptr(),
        consts.data_ptr(), out.data_ptr(), n_slices, width, c, ld, k_tile,
        contrib.shape[0] - 1, split.threads, split.parts,
        int(contrib.dtype == torch.float64),
        torch.cuda.current_stream().cuda_stream)
    _raise_on(err, lib, f"pagerank_step_sell ({n_slices}, {c}, {width}) "
              f"bucket, k_tile={k_tile}, {split.group} lanes a node, "
              f"{split.parts} parts")
    _count("pagerank_step_sell", contrib.dtype)


def pagerank_step_sell(bucket_radj, bucket_nodes, contrib: torch.Tensor,
                       consts: torch.Tensor) -> torch.Tensor:
    """One power step over width-bucketed, in-degree-sorted adjacency.

    ``contrib`` is (n + 1,) for a single configuration or (n + 1, k) for k
    stacked ones (dump slot = 0); ``consts`` is (3,) or (3, k) to match.
    The per-bucket results are scattered back to original node order
    through ``bucket_nodes``; returns the new rank matrix, same shape as
    ``contrib``.  On the card every non-empty bucket is one launch of
    kernel B3, walked as :func:`repro_torch.core.autotune.node_split`
    chooses: bit-equal to the unsplit walk, except on a bucket split into
    parts, whose partial sums are added in a fixed pairwise order
    (deterministic, within rtol 1e-10 of the plain version).
    """
    _check_state(contrib, consts)
    if contrib.device.type == "cpu":
        return pagerank_step_sell_ref(bucket_radj, bucket_nodes, contrib,
                                      consts)
    _require_cuda(contrib, "pagerank_step_sell")
    contrib, consts = contrib.contiguous(), consts.contiguous()
    if contrib.data_ptr() % 16:                 # the kernel's 16 B row loads
        contrib = contrib.clone()
    out = torch.zeros_like(contrib)
    sell_core.bucketed_node_step(
        lambda radj, nodes, kt: _launch_sell_bucket(radj, nodes, contrib,
                                                    consts, out, kt),
        bucket_radj, bucket_nodes, contrib)
    return out


def broadcast_configs(damping, iters) -> tuple[np.ndarray, np.ndarray]:
    """Broadcast scalar-or-sequence ``damping`` / ``iters`` against each
    other into equal-length config columns — the one definition of the
    batched-PageRank request shape (shared with
    :func:`repro_torch.kernels.ops.pagerank`'s per-column ELLPACK path)."""
    dampings = np.atleast_1d(np.asarray(damping, np.float64))
    iters_arr = np.atleast_1d(np.asarray(iters, np.int64))
    k = max(len(dampings), len(iters_arr))
    try:
        return (np.broadcast_to(dampings, (k,)),
                np.broadcast_to(iters_arr, (k,)))
    except ValueError:
        raise ValueError(
            f"damping ({len(dampings)}) and iters ({len(iters_arr)}) must "
            "be scalars or equal-length sequences") from None


def power_iteration(step, out_degree: torch.Tensor, n_nodes: int, damping,
                    iters, dtype=RANK_DTYPE) -> torch.Tensor:
    """The power iteration of the SELL drives around ``step(contrib,
    consts)``, which returns the new ``(n + 1[, k])`` ranks of one power
    step: ``contrib`` carries the dump slot's zero row, ``consts`` is (3,)
    or (3, k).  Shared by :func:`pagerank_sell` and the sharded drive
    (:func:`repro_torch.kernels.sell_shard.pagerank_sell_sharded`), so both
    iterate alike.  Returns (n,) ranks for scalar configurations, (n, k)
    for k."""
    dtype = _rank_dtype(dtype)
    scalar = np.ndim(damping) == 0 and np.ndim(iters) == 0
    n = n_nodes
    device = out_degree.device
    if scalar:                                # single-column fast path
        rank = torch.full((n,), 1.0 / n, dtype=dtype, device=device)
        deg = out_degree.to(dtype)
        head = torch.tensor([(1.0 - damping) / n, damping], dtype=dtype,
                            device=device)
        zero = torch.zeros(1, dtype=dtype, device=device)
        for _ in range(int(iters)):
            contrib = torch.where(deg > 0, rank / torch.clamp(deg, min=1), 0.0)
            dangling = torch.where(deg == 0, rank, 0.0).sum()
            consts = torch.cat([head, (dangling / n).reshape(1)])
            new = step(torch.cat([contrib, zero]), consts)  # dump slot: 0
            rank = new[:n]
        return rank
    dampings, iters_arr = broadcast_configs(damping, iters)
    k = len(dampings)
    rank = torch.full((n, k), 1.0 / n, dtype=dtype, device=device)
    deg = out_degree.to(dtype)[:, None]       # (n, 1) broadcasts over columns
    d = torch.tensor(dampings, dtype=dtype, device=device)             # (k,)
    head = torch.stack([(1.0 - d) / n, d])                            # (2, k)
    zero_row = torch.zeros((1, k), dtype=dtype, device=device)
    budget = torch.tensor(iters_arr, dtype=torch.int64, device=device)
    for t in range(1, int(iters_arr.max(initial=0)) + 1):
        contrib = torch.where(deg > 0, rank / torch.clamp(deg, min=1), 0.0)
        dangling = torch.where(deg == 0, rank, 0.0).sum(dim=0)       # (k,)
        consts = torch.cat([head, (dangling / n)[None]])              # (3, k)
        new = step(torch.cat([contrib, zero_row]), consts)  # dump slot: 0
        rank = torch.where((t <= budget)[None, :], new[:n], rank)  # freeze
    return rank


def _pagerank_sell_drive(step, bucket_radj, bucket_nodes, out_degree,
                         n_nodes: int, damping, iters, dtype) -> torch.Tensor:
    bucket_radj = tuple(sell_core.graph_storage(a) for a in bucket_radj)
    return power_iteration(
        lambda contrib, consts: step(bucket_radj, bucket_nodes, contrib,
                                     consts),
        out_degree, n_nodes, damping, iters, dtype)


def pagerank_sell(bucket_radj, bucket_nodes, out_degree: torch.Tensor,
                  n_nodes: int, *, damping=0.85, iters=20,
                  dtype: torch.dtype = RANK_DTYPE) -> torch.Tensor:
    """Full PageRank over bucketed SELL reverse adjacency, batched configs.

    ``damping`` / ``iters`` may be scalars or sequences: configurations are
    broadcast against each other and become iterate columns, so k requests
    run as one launch set per power step.  A column whose ``iters`` budget
    is exhausted freezes while longer ones keep iterating.  ``out_degree``
    is the (n_nodes,) degree vector in *original* node order, on the
    device the step runs on; returns (n_nodes,) ranks of ``dtype`` (float64
    or float32) for scalar inputs, (n_nodes, k) otherwise.
    """
    return _pagerank_sell_drive(pagerank_step_sell, bucket_radj, bucket_nodes,
                                out_degree, n_nodes, damping, iters, dtype)


def pagerank_sell_ref(bucket_radj, bucket_nodes, out_degree: torch.Tensor,
                      n_nodes: int, *, damping=0.85, iters=20,
                      dtype: torch.dtype = RANK_DTYPE) -> torch.Tensor:
    """:func:`pagerank_sell` driven by the plain step on any device."""
    return _pagerank_sell_drive(pagerank_step_sell_ref, bucket_radj,
                                bucket_nodes, out_degree, n_nodes, damping,
                                iters, dtype)
