"""Sharded SELL execution over a mesh of devices: the port of
``repro.kernels.sell_shard``.

Row-partitioning the SELL slabs across devices puts more lanes in flight a
launch, with the cross-device combine in the role the paper's long-vector
gather plays within one core.  Four drives, each on top of the port's
single-device kernels:

* :func:`spmm_sell_sharded` — row-sharded SpMM over a
  :class:`~repro_torch.sparse.formats.ShardedSlabs` partition: shard ``d``
  runs :func:`~repro_torch.kernels.sell_core.spmm_sell` (kernel B1) over its
  own buckets against the ``window_cols`` rows of X its columns name (the
  boundary-column gather), into ``rows_max + 1`` local rows; the row blocks
  concatenate (rows are disjoint: no reduction);
* :func:`spmm_sell_rhs_sharded` — the k >> k_block path: every device holds
  the whole operand and computes all rows for its slice of the RHS columns
  (whole k tiles a device; no combine but the concatenation);
* :func:`bfs_sell_sharded` / :func:`pagerank_sell_sharded` — per level or
  power step, shard ``d`` runs kernel B3 (:func:`~repro_torch.kernels.bfs
  .bfs_step_sell` / :func:`~repro_torch.kernels.pagerank.pagerank_step_sell`)
  over its owned nodes against the replicated state, then the states
  combine: BFS by an element-wise minimum (an update only lowers INF to the
  level; the reference's ``pmin``), PageRank by a sum (a shard writes its
  own nodes' ranks into zeros; the reference's ``psum``).

The mesh is one process driving a tuple of devices (:class:`ShardMesh`,
the counterpart of the reference's one-controller ``shard_map``): each
shard's work is issued on its device's current stream, with X or the state
copied there once a call (once a level or step for the graphs), and the
combine runs on ``mesh[0]``, where the result lands.  A mesh may name one
device several times — ``("cuda:0",) * 4`` runs the whole mesh path on one
card, ``("cpu",) * 4`` on the CPU (the counterpart of the reference's
``--xla_force_host_platform_device_count``).  With no mesh (``mesh=None``
or the null mesh) every drive folds the same per-shard program serially on
one device.  Every node and row is owned by one shard, so the min and the
sum are exact in any order: the mesh path is bit-identical to the serial
fold.  No ``torch.distributed`` group is involved.

On CUDA devices the shards launch their kernels or raise; on CPU devices,
and only there, the wrappers run their plain versions.
"""
from __future__ import annotations

import dataclasses
from typing import Sequence

import numpy as np
import torch

from repro_torch.graphs.gen import ShardedGraphSlabs
from repro_torch.kernels import bfs as bfs_k
from repro_torch.kernels import pagerank as pr_k
from repro_torch.kernels import sell_core, uploads
from repro_torch.kernels.execspec import resolve_device
from repro_torch.sparse.formats import SellSlabs, ShardedSlabs

#: the canonical name of the one mesh axis of sharded SELL execution
SHARD_AXIS = "shard"

__all__ = [
    "SHARD_AXIS",
    "ShardMesh",
    "bfs_sell_sharded",
    "device_mesh",
    "pagerank_sell_sharded",
    "spmm_sell_rhs_sharded",
    "spmm_sell_sharded",
    "upload",
]


@dataclasses.dataclass(frozen=True)
class ShardMesh:
    """A 1-D mesh: the devices of axis :data:`SHARD_AXIS`, in shard order.
    ``ShardMesh()`` (no devices) is the null mesh: single-device execution,
    the serial fold for an explicitly sharded layout."""

    devices: tuple[torch.device, ...] = ()

    def __len__(self) -> int:
        return len(self.devices)

    def __getitem__(self, d: int) -> torch.device:
        return self.devices[d]

    def __iter__(self):
        return iter(self.devices)


def _device(d) -> torch.device:
    """A mesh entry as a checked device; ``cuda`` without an index is
    the current card."""
    dev = resolve_device(d)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    if dev.type == "cuda" and dev.index >= torch.cuda.device_count():
        raise ValueError(f"mesh device {dev} is not visible "
                         f"({torch.cuda.device_count()} CUDA device(s))")
    return dev


def device_mesh(n_devices: int, devices: Sequence | None = None) -> ShardMesh:
    """A 1-D ``(n_devices,)`` mesh.

    ``n_devices <= 1`` gives the null mesh.  Without ``devices`` the mesh
    takes the first ``n_devices`` distinct visible CUDA devices and raises
    ``ValueError`` if fewer are visible (no fallback).  ``devices`` names
    the devices, the first ``n_devices`` of them, and may repeat one:
    ``("cuda:0",) * 4`` on one card, ``("cpu",) * 4`` on the CPU.
    """
    n = int(n_devices)
    if n <= 1:
        return ShardMesh()
    if devices is None:
        visible = torch.cuda.device_count() if torch.cuda.is_available() else 0
        if visible < n:
            raise ValueError(
                f"placement asks for {n} devices but only {visible} CUDA "
                f"device(s) are visible; name the devices to share one, "
                f"e.g. devices=('cuda:0',) * {n}, or ('cpu',) * {n} on the "
                "CPU")
        return ShardMesh(tuple(torch.device("cuda", i) for i in range(n)))
    devs = tuple(_device(d) for d in devices)
    if len(devs) < n:
        raise ValueError(f"placement asks for {n} devices but names "
                         f"{len(devs)}: {[str(d) for d in devs]}")
    devs = devs[:n]
    if len({d.type for d in devs}) != 1:
        raise ValueError(f"a mesh runs on one device type, got "
                         f"{[str(d) for d in devs]}")
    return ShardMesh(devs)


def _mesh_devices(mesh, n_shards: int) -> tuple[torch.device, ...] | None:
    """The devices of a mesh given as a :class:`ShardMesh`, a device
    sequence or None, checked against the layout's shard count; None for
    the null mesh (the serial fold)."""
    if mesh is None:
        return None
    if not isinstance(mesh, ShardMesh):
        mesh = device_mesh(len(mesh), mesh)
    if len(mesh) == 0:
        return None
    if len(mesh) != int(n_shards):
        raise ValueError(
            f"mesh axis {SHARD_AXIS!r} has {len(mesh)} devices but the "
            f"operand is partitioned into {n_shards} shards")
    return mesh.devices


# ---------------------------------------------------------------------------
# Uploads: each shard once a device, in the port's one memo (uploads)
# ---------------------------------------------------------------------------


def upload(layout, mesh) -> None:
    """Upload every shard of a :class:`ShardedSlabs` /
    :class:`ShardedGraphSlabs` to its device of ``mesh`` now, so the drives
    touch only device-resident tensors (the registry calls this at
    registration)."""
    devs = _mesh_devices(mesh, layout.n_shards)
    if devs is None:
        raise ValueError("upload needs a mesh of the layout's shard count")
    for d, dev in enumerate(devs):
        uploads.on_device(layout, dev, d)


def _as_tensor(x) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x
    return torch.from_numpy(np.ascontiguousarray(x))


class _Replicas:
    """One tensor copied once to each device that asks for it (the
    replicated X or graph state of one call, level or step)."""

    def __init__(self, *tensors: torch.Tensor):
        self._tensors = tensors
        self._on: dict[torch.device, tuple] = {}

    def on(self, device: torch.device) -> tuple:
        if device not in self._on:
            self._on[device] = tuple(t.to(device) for t in self._tensors)
        return self._on[device]


# ---------------------------------------------------------------------------
# Row-sharded and RHS-sharded SpMM
# ---------------------------------------------------------------------------


def spmm_sell_sharded(sharded: ShardedSlabs, x, *, mesh=None,
                      k_block: int = 8) -> torch.Tensor:
    """Y = A @ X with A row-partitioned across a mesh; X is (n_cols, k).

    Shard ``d`` runs :func:`~repro_torch.kernels.sell_core.spmm_sell` over
    its buckets against ``X[col_starts[d] : col_starts[d] + window_cols]``
    (its stored columns are rebased into that window) into ``rows_max + 1``
    local rows, of which its ``row_counts[d]`` are kept.  The row blocks
    concatenate on ``mesh[0]`` (with no mesh: on X's device, the shards run
    one after another there).  Returns Y (n_rows, k).
    """
    x = _as_tensor(x)
    if x.ndim != 2:
        raise ValueError(f"X must be (n_cols, k), got shape {tuple(x.shape)}")
    nsh = sharded.n_shards
    devs = _mesh_devices(mesh, nsh)
    home = devs[0] if devs else x.device
    win = int(sharded.window_cols)
    xs = _Replicas(x)
    pieces = []
    for d in range(nsh):
        dev = devs[d] if devs else x.device
        cols, vals, rows = uploads.on_device(sharded, dev, d)
        lo = int(sharded.col_starts[d])
        y = sell_core.spmm_sell(cols, vals, rows, xs.on(dev)[0][lo:lo + win],
                                n_rows=sharded.rows_max, k_block=k_block)
        pieces.append(y[:int(sharded.row_counts[d])])
    return torch.cat([p.to(home) for p in pieces])[:sharded.n_rows]


def spmm_sell_rhs_sharded(slabs: SellSlabs, x, *, mesh=None,
                          k_block: int = 8) -> torch.Tensor:
    """Y = A @ X with the RHS *columns* sharded: the k >> k_block path.

    Every device holds the whole operand and runs
    :func:`~repro_torch.kernels.sell_core.spmm_sell` on its slice of the k
    columns, padded to ``n_devices * k_tile`` columns so each device gets
    whole k tiles; the column blocks concatenate on ``mesh[0]``.  Columns
    are independent, so the result is bit-equal to the one-device call.
    With no mesh it is that call, on X's device.
    """
    x = _as_tensor(x)
    if x.ndim != 2:
        raise ValueError(f"X must be (n_cols, k), got shape {tuple(x.shape)}")
    if mesh is not None and not isinstance(mesh, ShardMesh):
        mesh = device_mesh(len(mesh), mesh)
    if mesh is None or len(mesh) == 0:
        cols, vals, rows = uploads.on_device(slabs, x.device)
        return sell_core.spmm_sell(cols, vals, rows, x, n_rows=slabs.n_rows,
                                   k_block=k_block)
    n = len(mesh)
    k = int(x.shape[1])
    kp = sell_core.k_tile_for(k, k_block)
    xk = n * kp * -(-k // (n * kp))            # whole k tiles a device
    if xk != k:
        x = torch.nn.functional.pad(x, (0, xk - k))
    per = xk // n
    pieces = []
    for d, dev in enumerate(mesh):
        cols, vals, rows = uploads.on_device(slabs, dev)
        xd = x[:, d * per:(d + 1) * per].to(dev)
        pieces.append(sell_core.spmm_sell(cols, vals, rows, xd,
                                          n_rows=slabs.n_rows,
                                          k_block=k_block))
    return torch.cat([p.to(mesh[0]) for p in pieces], dim=1)[:, :k]


# ---------------------------------------------------------------------------
# Graph drives: a per-shard node step, then the combine
# ---------------------------------------------------------------------------


def _graph_step(sg: ShardedGraphSlabs, devs, home: torch.device, step,
                combine, state: tuple, *args) -> torch.Tensor:
    """One combined node step: ``step(adj, nodes, *state, *args)`` on every
    shard against the ``state`` tensors copied once to each device, the
    shards' results folded in shard order on ``home`` by ``combine``."""
    reps = _Replicas(*state)
    parts = []
    for d in range(sg.n_shards):
        dev = devs[d] if devs else home
        adj, nodes = uploads.on_device(sg, dev, d)
        parts.append(step(adj, nodes, *reps.on(dev), *args))
    acc = parts[0].to(home)
    for part in parts[1:]:
        acc = combine(acc, part.to(home))
    return acc


def _home(devs, device) -> torch.device:
    """Where a graph drive's state lives: ``mesh[0]``, or ``device`` (the
    card when None) for the serial fold."""
    if devs:
        return devs[0]
    return resolve_device(device)


def bfs_sell_sharded(sg: ShardedGraphSlabs, source, *, mesh=None,
                     max_levels: int | None = None,
                     device=None) -> torch.Tensor:
    """BFS over node-partitioned SELL in-adjacency: each level, every shard
    advances its owned nodes against the replicated distances (a fresh copy
    that keeps the old distance elsewhere), and the shards' states fold by
    an element-wise minimum: an update only lowers INF to the level, so the
    minimum is the frontier union.  The contract of
    :func:`~repro_torch.kernels.bfs.bfs_sell` (scalar source -> (n,), k
    sources -> (n, k)); the state lives on ``mesh[0]``, or on ``device``
    (the card when None) with no mesh."""
    devs = _mesh_devices(mesh, sg.n_shards)
    home = _home(devs, device)
    return bfs_k.level_sync(
        lambda dist, level: _graph_step(sg, devs, home, bfs_k.bfs_step_sell,
                                        torch.minimum, (dist,), level),
        sg.n_nodes, source, home, max_levels)


def pagerank_sell_sharded(sg: ShardedGraphSlabs, out_degree, *, mesh=None,
                          damping=0.85, iters=20,
                          dtype: torch.dtype = pr_k.RANK_DTYPE,
                          device=None) -> torch.Tensor:
    """PageRank over node-partitioned SELL reverse adjacency: each power
    step, every shard writes the new ranks of its owned nodes into zeros,
    and the shards' ranks fold by addition: each node is owned once, so the
    sum assembles the whole iterate (the rank exchange).  The contract of
    :func:`~repro_torch.kernels.pagerank.pagerank_sell` (scalar config ->
    (n,), broadcast (damping, iters) columns -> (n, k)), in ``dtype``
    (float64 or float32); ``out_degree`` is the (n,) out-degree vector in
    node order."""
    devs = _mesh_devices(mesh, sg.n_shards)
    home = _home(devs, device)
    deg = _as_tensor(out_degree).to(device=home, dtype=torch.float64)
    return pr_k.power_iteration(
        lambda contrib, consts: _graph_step(
            sg, devs, home, pr_k.pagerank_step_sell, torch.add,
            (contrib, consts)),
        deg, sg.n_nodes, damping, iters, dtype)
