"""Graph generation, SELL slab packing and host references for BFS and
PageRank (paper §3.1).

The port's copy of ``repro.graphs.gen``, the node-partitioned layout
of the sharded drives (:class:`ShardedGraphSlabs`) included.  The
generators draw the same random stream as the reference, so the same seed
gives the byte-identical graph, and :func:`graph_to_sell_slabs` builds the
byte-identical slabs (tests hold both against the reference).  Packing and
the references stay on the host, in numpy.

What is new here is the boundary to the card.  The reference's graph slabs
are node-major, ``(n_slices, C, W_b)``; the graph kernels walk a node's
in-neighbours with one thread per node, so node-major storage would put
neighbouring threads ``W_b * 4`` bytes apart.  The uploads therefore store
the neighbour axis outermost — ``(S, W_b, C)`` per bucket and ``(width,
n)`` for ELLPACK — and hand back views with the reference's logical shape
(``(S, C, W_b)`` and ``(n, width)``), so public functions keep the
reference layout while the kernels read coalesced lanes.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.sparse.formats import (
    next_pow2,
    shard_row_ranges,
    sigma_sort_order,
    slice_widths,
)

__all__ = [
    "INF",
    "PAD",
    "EllpackGraph",
    "SellGraphSlabs",
    "ShardedGraphSlabs",
    "bfs_reference",
    "graph_to_sell_slabs",
    "pagerank_reference",
    "random_graph",
    "rmat_graph",
    "shard_graph_slabs",
]

PAD = -1
INF = np.iinfo(np.int32).max


def _lane_minor(a: np.ndarray, device) -> torch.Tensor:
    """Upload ``a`` with its last two axes swapped in memory and return the
    view with ``a``'s own shape: the last axis is the slowest in memory."""
    swapped = np.ascontiguousarray(np.swapaxes(a, -1, -2))
    return torch.from_numpy(swapped).to(device).transpose(-1, -2)


@dataclasses.dataclass(frozen=True)
class EllpackGraph:
    """Degree-padded adjacency: ``adj[v, k]`` = k-th out-neighbor of v or PAD."""

    adj: np.ndarray          # (n, width) int32
    n_nodes: int

    @property
    def width(self) -> int:
        return self.adj.shape[1]

    @property
    def n_edges(self) -> int:
        return int((self.adj != PAD).sum())

    @property
    def out_degree(self) -> np.ndarray:
        return (self.adj != PAD).sum(axis=1)

    def transpose(self) -> "EllpackGraph":
        """Reverse graph (in-neighbors), used by pull-style PageRank.

        Vectorized (stable sort by destination + one scatter), so reversing
        stays cheap at millions of edges.
        """
        src, k = np.nonzero(self.adj != PAD)
        dst = self.adj[src, k]
        order = np.argsort(dst, kind="stable")
        src, dst = src[order], dst[order]
        counts = np.bincount(dst, minlength=self.n_nodes)
        width = max(1, int(counts.max()) if len(counts) else 1)
        radj = np.full((self.n_nodes, width), PAD, np.int32)
        starts = np.zeros(self.n_nodes + 1, np.int64)
        np.cumsum(counts, out=starts[1:])
        within = np.arange(len(src), dtype=np.int64) - starts[dst]
        radj[dst, within] = src
        return EllpackGraph(adj=radj, n_nodes=self.n_nodes)

    def to_device(self, device) -> torch.Tensor:
        """The adjacency on ``device`` as an ``(n, width)`` view of
        ``(width, n)`` storage: thread v of an ELLPACK kernel reads
        ``adj[v, w]`` beside thread v + 1."""
        return _lane_minor(self.adj, device)


@dataclasses.dataclass(frozen=True)
class SellGraphSlabs:
    """Width-bucketed SELL-C-sigma adjacency for the pull-style kernels.

    Nodes are sorted by degree within sigma windows and grouped into
    C-node slices; slices are padded to the next power-of-two width and
    bucketed by that width.  ``bucket_adj[b]`` is (n_slices_b, C, W_b) —
    node-major, matching the (vl, width) orientation of the BFS/PageRank
    kernels — and ``bucket_nodes[b]`` is (n_slices_b, C) mapping each lane
    to its original node id (``n_nodes`` = padding/dump slot).
    """

    bucket_adj: tuple[np.ndarray, ...]    # each (n_slices_b, C, W_b) int32
    bucket_nodes: tuple[np.ndarray, ...]  # each (n_slices_b, C) int32
    n_nodes: int
    sigma: int

    @property
    def c(self) -> int:
        return self.bucket_adj[0].shape[1]

    @property
    def widths(self) -> tuple[int, ...]:
        return tuple(a.shape[2] for a in self.bucket_adj)

    @property
    def n_edges(self) -> int:
        return int(sum((a != PAD).sum() for a in self.bucket_adj))

    @property
    def padded_entries(self) -> int:
        return sum(a.size for a in self.bucket_adj)

    @property
    def pad_factor(self) -> float:
        return self.padded_entries / max(self.n_edges, 1)

    def to_device(self, device) -> tuple[tuple[torch.Tensor, ...],
                                         tuple[torch.Tensor, ...]]:
        """The bucket tensors on ``device``: ``(adj, nodes)``, each a tuple
        over buckets.  ``adj[b]`` has the reference's (S, C, W_b) shape but
        (S, W_b, C) storage, so the lanes of one slice are adjacent in
        memory for every neighbour slot.  This is the one upload."""
        return (tuple(_lane_minor(a, device) for a in self.bucket_adj),
                tuple(torch.from_numpy(np.ascontiguousarray(m)).to(device)
                      for m in self.bucket_nodes))


def graph_to_sell_slabs(
    g: EllpackGraph, c: int, sigma: int | None = None
) -> SellGraphSlabs:
    """Bucket a degree-padded graph into SELL slabs (vectorized).

    The adjacency rows are already materialized in ``g.adj``; slabs are just
    a degree-sorted row gather plus per-bucket column trims, so conversion
    is a handful of array ops even at millions of nodes.
    """
    sigma = int(sigma or 8 * c)
    n = g.n_nodes
    deg = (g.adj != PAD).sum(axis=1).astype(np.int64)
    order = sigma_sort_order(deg, sigma)
    bwidths = next_pow2(slice_widths(deg, order, c))
    n_slices = len(bwidths)

    nodes_padded = np.full(n_slices * c, n, np.int64)
    nodes_padded[:n] = order
    nodes_by_slice = nodes_padded.reshape(n_slices, c).astype(np.int32)

    # Sorted adjacency with a PAD guard row for padding lanes.
    adj_guard = np.concatenate(
        [g.adj, np.full((1, g.width), PAD, np.int32)], axis=0
    )
    bucket_adj, bucket_nodes = [], []
    for w in np.unique(bwidths):
        ids = np.nonzero(bwidths == w)[0]
        rows = adj_guard[nodes_by_slice[ids].reshape(-1)]   # (S_b*C, width)
        w = int(w)
        if w <= g.width:
            rows = rows[:, :w]
        else:
            rows = np.pad(rows, ((0, 0), (0, w - g.width)), constant_values=PAD)
        bucket_adj.append(np.ascontiguousarray(rows.reshape(len(ids), c, w)))
        bucket_nodes.append(nodes_by_slice[ids])
    kept = sum(int((a != PAD).sum()) for a in bucket_adj)
    if kept != int(deg.sum()):
        raise ValueError(
            "adjacency rows must be left-justified (neighbors in columns "
            "[0, degree)); the width trim dropped edges"
        )
    return SellGraphSlabs(
        bucket_adj=tuple(bucket_adj),
        bucket_nodes=tuple(bucket_nodes),
        n_nodes=n,
        sigma=sigma,
    )


@dataclasses.dataclass(frozen=True)
class ShardedGraphSlabs:
    """Node-partitioned :class:`SellGraphSlabs`, stacked along a device axis.

    Shard ``d`` owns the contiguous node range ``[node_starts[d],
    node_starts[d] + node_counts[d])`` and carries that range's in-degree
    sorted adjacency as a common bucket structure (same widths and slice
    counts on every shard, PAD-padded), so one program serves all
    devices.  Unlike the matrix case, ids stay GLOBAL: ``bucket_adj`` holds
    global neighbor ids (the frontier/rank state is replicated, so every
    shard gathers from the full vector) and ``bucket_nodes`` holds global
    owned-node ids (padding lanes map to ``n_nodes``, the shared dump slot)
    — each shard scatters only its own nodes, and the cross-device combine
    (BFS frontier union by element-wise min, PageRank rank exchange by
    sum) merges
    the disjoint updates.
    """

    bucket_adj: tuple[np.ndarray, ...]    # each (n_shards, S_b, C, W_b) int32
    bucket_nodes: tuple[np.ndarray, ...]  # each (n_shards, S_b, C) int32
    node_starts: np.ndarray               # (n_shards,) int64
    node_counts: np.ndarray               # (n_shards,) int64
    n_nodes: int
    sigma: int

    @property
    def c(self) -> int:
        return self.bucket_adj[0].shape[2]

    @property
    def n_shards(self) -> int:
        return self.bucket_adj[0].shape[0]

    @property
    def widths(self) -> tuple[int, ...]:
        return tuple(a.shape[3] for a in self.bucket_adj)

    @property
    def slices_per_shard(self) -> tuple[int, ...]:
        return tuple(a.shape[1] for a in self.bucket_adj)

    def shard_to_device(self, d: int, device) -> tuple[tuple[torch.Tensor, ...],
                                                       tuple[torch.Tensor, ...]]:
        """Shard ``d``'s bucket tensors on ``device``: ``(adj, nodes)``, each
        a tuple over the union buckets, stored as
        :meth:`SellGraphSlabs.to_device` stores one graph (adjacency
        (S, W, C) in memory, viewed (S, C, W)).  The one upload of that
        shard."""
        return (tuple(_lane_minor(a[d], device) for a in self.bucket_adj),
                tuple(torch.from_numpy(np.ascontiguousarray(m[d])).to(device)
                      for m in self.bucket_nodes))


def shard_graph_slabs(
    g: EllpackGraph, c: int, n_shards: int, sigma: int | None = None
) -> ShardedGraphSlabs:
    """Node-partition a (reverse) graph into per-device SELL slabs.

    Nodes split into contiguous in-degree-balanced ranges; each range is
    degree-sorted and bucketed *locally* (so no slice mixes nodes across
    the partition), then the per-shard structures are padded to the union
    bucket layout exactly as :func:`repro.sparse.formats.shard_slabs` does
    for matrices.
    """
    sigma = int(sigma or 8 * c)
    n = g.n_nodes
    deg = (g.adj != PAD).sum(axis=1).astype(np.int64)
    ranges = shard_row_ranges(deg, n_shards)
    n_shards = len(ranges)
    shards = []
    for lo, hi in ranges:
        sub = EllpackGraph(adj=g.adj[lo:hi], n_nodes=hi - lo)
        shards.append((lo, graph_to_sell_slabs(sub, c=c, sigma=sigma)))

    per_shard = [dict(zip(s.widths, range(len(s.bucket_adj))))
                 for _, s in shards]
    union_w = sorted({w for _, s in shards for w in s.widths})
    smax = {
        w: max(
            (s.bucket_adj[per_shard[d][w]].shape[0]
             if w in per_shard[d] else 0)
            for d, (_, s) in enumerate(shards))
        for w in union_w
    }
    bucket_adj, bucket_nodes = [], []
    for w in union_w:
        s_b = smax[w]
        adj = np.full((n_shards, s_b, c, w), PAD, np.int32)
        nodes = np.full((n_shards, s_b, c), n, np.int32)
        for d, (lo, s) in enumerate(shards):
            if w not in per_shard[d]:
                continue  # empty per-device bucket: stays all-PAD
            b = per_shard[d][w]
            sa, sn = s.bucket_adj[b], s.bucket_nodes[b]
            nb = sa.shape[0]
            adj[d, :nb] = sa                    # neighbor ids already global
            # owned nodes: local sorted ids -> global; pads -> global dump
            nodes[d, :nb] = np.where(sn == s.n_nodes, n, sn + lo)
        bucket_adj.append(adj)
        bucket_nodes.append(nodes)
    return ShardedGraphSlabs(
        bucket_adj=tuple(bucket_adj),
        bucket_nodes=tuple(bucket_nodes),
        node_starts=np.array([lo for lo, _ in ranges], np.int64),
        node_counts=np.array([hi - lo for lo, hi in ranges], np.int64),
        n_nodes=n,
        sigma=sigma,
    )


def random_graph(
    n_nodes: int = 1 << 15,
    avg_degree: int = 16,
    seed: int = 0,
    connected_ring: bool = True,
) -> EllpackGraph:
    """Uniform random digraph, optional ring to guarantee reachability."""
    rng = np.random.default_rng(seed)
    deg = np.clip(rng.poisson(avg_degree - 1, n_nodes) + 1, 1, 4 * avg_degree)
    width = int(deg.max()) + (1 if connected_ring else 0)
    adj = np.full((n_nodes, width), PAD, np.int32)
    for v in range(n_nodes):
        k = int(deg[v])
        nbrs = rng.choice(n_nodes, size=k, replace=False)
        adj[v, :k] = nbrs
        if connected_ring:
            adj[v, k] = (v + 1) % n_nodes
    return EllpackGraph(adj=adj, n_nodes=n_nodes)


def rmat_graph(
    n_nodes: int = 1 << 15,
    avg_degree: int = 16,
    seed: int = 0,
    a: float = 0.57,
    b: float = 0.19,
    c: float = 0.19,
    degree_cap_factor: int = 8,
) -> EllpackGraph:
    """R-MAT (Graph500-style skewed) generator, degree-capped for ELLPACK."""
    rng = np.random.default_rng(seed)
    scale = int(np.log2(n_nodes))
    n_edges = n_nodes * avg_degree
    src = np.zeros(n_edges, np.int64)
    dst = np.zeros(n_edges, np.int64)
    for bit in range(scale):
        r = rng.random(n_edges)
        s_bit = r >= a + b                     # lower half for source
        r2 = rng.random(n_edges)
        d_bit = np.where(s_bit, r2 >= c / max(c + (1 - a - b - c), 1e-9),
                         r2 >= a / max(a + b, 1e-9))
        src |= s_bit.astype(np.int64) << bit
        dst |= d_bit.astype(np.int64) << bit
    cap = degree_cap_factor * avg_degree
    adj_lists: list[list[int]] = [[] for _ in range(n_nodes)]
    for s, d in zip(src, dst):
        if len(adj_lists[s]) < cap and s != d:
            adj_lists[s].append(int(d))
    width = max(1, max(len(l) for l in adj_lists))
    adj = np.full((n_nodes, width), PAD, np.int32)
    for v, l in enumerate(adj_lists):
        adj[v, : len(l)] = l
    return EllpackGraph(adj=adj, n_nodes=n_nodes)


# ---------------------------------------------------------------------------
# Host references
# ---------------------------------------------------------------------------


def bfs_reference(g: EllpackGraph, source: int = 0) -> np.ndarray:
    """Level-synchronous BFS distances (int32, INF = unreachable)."""
    dist = np.full(g.n_nodes, INF, np.int32)
    dist[source] = 0
    frontier = np.array([source], np.int64)
    level = 0
    while len(frontier):
        level += 1
        nbrs = g.adj[frontier].reshape(-1)
        nbrs = nbrs[nbrs != PAD]
        nbrs = np.unique(nbrs)
        new = nbrs[dist[nbrs] == INF]
        dist[new] = level
        frontier = new
    return dist


def pagerank_reference(
    g: EllpackGraph,
    damping: float = 0.85,
    iters: int = 20,
    dtype=np.float64,
) -> np.ndarray:
    """Pull-style power iteration with dangling-mass redistribution."""
    n = g.n_nodes
    out_deg = g.out_degree.astype(dtype)
    rt = g.transpose()
    rank = np.full(n, 1.0 / n, dtype)
    for _ in range(iters):
        contrib = np.where(out_deg > 0, rank / np.maximum(out_deg, 1), 0.0)
        dangling = rank[out_deg == 0].sum()
        gathered = np.where(rt.adj == PAD, 0.0, contrib[np.clip(rt.adj, 0, n - 1)])
        rank = (1.0 - damping) / n + damping * (gathered.sum(axis=1) + dangling / n)
    return rank
