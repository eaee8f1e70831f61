"""Parity of the port's graph path (``repro_torch.graphs``,
``repro_torch.kernels.{bfs,pagerank}``, the graph half of
``repro_torch.kernels.ops`` and its preflight) with the JAX reference.

The same numpy-seeded graphs go through both packages.  The reference's
Pallas kernels run in interpret mode with x64 on (as
``tests/test_kernels.py`` and ``tests/test_sell.py`` run them); the port's
wrappers take their plain PyTorch paths because the tensors lie on the
CPU.  Tolerance: BFS distances exactly equal; PageRank ranks at rtol 1e-10
(only the summation order differs).  The CUDA kernels themselves are held
against these plain versions on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.graphs import gen as RG
from repro.kernels import bfs as ref_bfs
from repro.kernels import ops as ref_ops
from repro.kernels import pagerank as ref_pr
from repro.kernels.execspec import ExecSpec as RefExecSpec
from repro_torch.analysis import (
    LaunchPlanError,
    LiveWidthMeta,
    SlabMeta,
    plan_bfs_ell,
    plan_bfs_sell,
    plan_pagerank_ell,
    plan_pagerank_sell,
)
from repro_torch.core import autotune
from repro_torch.graphs import gen as G
from repro_torch.kernels import bfs, ops, pagerank, sell_core
from repro_torch.kernels.execspec import ExecSpec
from repro_torch.sparse import formats as F

RTOL = 1e-10
INF = G.INF
PAD = G.PAD
CPU = ExecSpec(device="cpu")


def _pair(kind="rmat", n=257, deg=8, seed=3):
    make = {"rmat": "rmat_graph", "uniform": "random_graph"}[kind]
    return getattr(RG, make)(n, deg, seed=seed), getattr(G, make)(n, deg, seed=seed)


def _t(a):
    return torch.from_numpy(np.array(a))


def _slabs(graph, c, sigma=None):
    """Reference slabs of the reverse graph, as jnp (reference) and as
    uploaded port tensors."""
    ref = RG.graph_to_sell_slabs(graph.transpose(), c=c, sigma=sigma)
    port = G.graph_to_sell_slabs(
        G.EllpackGraph(adj=graph.adj, n_nodes=graph.n_nodes).transpose(),
        c=c, sigma=sigma)
    jref = (tuple(jnp.asarray(a) for a in ref.bucket_adj),
            tuple(jnp.asarray(m) for m in ref.bucket_nodes))
    return jref, port.to_device("cpu")


def _dist0(n, sources, k=None):
    """The level-0 state: (n + 1,) for a scalar source, else (n + 1, k)."""
    if k is None:
        d = np.full(n + 1, INF, np.int32)
        d[sources] = 0
    else:
        d = np.full((n + 1, k), INF, np.int32)
        d[np.asarray(sources), np.arange(k)] = 0
    return d


# ---------------------------------------------------------------------------
# Generator and packer copies: byte-identical
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,n,deg,seed", [
    ("uniform", 300, 8, 1), ("uniform", 257, 4, 2), ("rmat", 256, 8, 0),
    ("rmat", 263, 16, 5)])
def test_generators_and_transpose_are_byte_identical(kind, n, deg, seed):
    ref, port = _pair(kind, n, deg, seed)
    assert port.adj.dtype == ref.adj.dtype
    assert port.adj.tobytes() == ref.adj.tobytes()
    assert port.n_edges == ref.n_edges
    assert np.array_equal(port.out_degree, ref.out_degree)
    assert port.transpose().adj.tobytes() == ref.transpose().adj.tobytes()
    no_ring_ref = RG.random_graph(n, deg, seed=seed, connected_ring=False)
    no_ring = G.random_graph(n, deg, seed=seed, connected_ring=False)
    assert no_ring.adj.tobytes() == no_ring_ref.adj.tobytes()


@pytest.mark.parametrize("c,sigma", [(8, None), (8, 16), (32, 64),
                                     (32, None), (128, 256)])
def test_graph_slabs_are_byte_identical(c, sigma):
    ref, port = _pair("rmat", 300, 8, 4)
    rs = RG.graph_to_sell_slabs(ref.transpose(), c=c, sigma=sigma)
    ps = G.graph_to_sell_slabs(port.transpose(), c=c, sigma=sigma)
    assert ps.widths == rs.widths and ps.sigma == rs.sigma
    assert ps.pad_factor == rs.pad_factor and ps.n_edges == rs.n_edges
    for a, b in zip(ps.bucket_adj + ps.bucket_nodes,
                    rs.bucket_adj + rs.bucket_nodes):
        assert a.dtype == b.dtype and a.tobytes() == b.tobytes()


def test_host_references_match():
    ref, port = _pair("uniform", 211, 6, 9)
    for s in (0, 17, 210):
        assert np.array_equal(G.bfs_reference(port, s),
                              RG.bfs_reference(ref, s))
    assert np.array_equal(G.pagerank_reference(port, 0.9, 7),
                          RG.pagerank_reference(ref, 0.9, 7))


def test_uploads_keep_the_reference_shape_in_lane_minor_storage():
    _, port = _pair("rmat", 200, 8, 1)
    slabs = G.graph_to_sell_slabs(port.transpose(), c=16)
    adj, nodes = slabs.to_device("cpu")
    for a, ref_a, m, ref_m in zip(adj, slabs.bucket_adj, nodes,
                                  slabs.bucket_nodes):
        assert tuple(a.shape) == ref_a.shape and a.dtype == torch.int32
        assert a.transpose(1, 2).is_contiguous()          # (S, W, C) storage
        assert np.array_equal(a.numpy(), ref_a)
        assert np.array_equal(m.numpy(), ref_m) and m.is_contiguous()
    ell = port.to_device("cpu")
    assert tuple(ell.shape) == port.adj.shape and ell.t().is_contiguous()
    assert np.array_equal(ell.numpy(), port.adj)
    # graph_storage is free on an upload and a relayout otherwise
    assert sell_core.graph_storage(ell).data_ptr() == ell.data_ptr()
    node_major = _t(port.adj)
    lm = sell_core.graph_storage(node_major)
    assert lm.t().is_contiguous() and torch.equal(lm, node_major)


def test_node_k_tile_divides_every_k():
    for k in range(1, 200):
        kt = sell_core.node_k_tile(k)
        assert k % kt == 0 and kt <= autotune.MAX_K_TILE
        assert kt & (kt - 1) == 0
    assert [sell_core.node_k_tile(k) for k in (1, 6, 12, 32, 48, 64)] == \
        [1, 2, 4, 32, 16, 32]


# ---------------------------------------------------------------------------
# Single steps against the reference kernels
# ---------------------------------------------------------------------------


def _holey_adj(adj: np.ndarray, seed: int) -> np.ndarray:
    """An (n, width) ELLPACK adjacency with PAD punched into a quarter of
    its slots, inside rows too, and the nodes 32 .. 63 (one warp) all
    PAD."""
    out = adj.copy()
    out[np.random.default_rng(seed).random(out.shape) < 0.25] = PAD
    out[32:64] = PAD
    return out


def _live_count_adj(adj: np.ndarray) -> np.ndarray:
    """Live widths of an (n, width) adjacency counted in numpy: per 32
    consecutive nodes, 1 + the last slot holding a neighbour."""
    slots = np.arange(1, adj.shape[1] + 1)
    rows = np.where(adj != PAD, slots, 0).max(axis=1, initial=0)
    rows = np.pad(rows, (0, -len(rows) % 32))
    return rows.reshape(-1, 32).max(axis=1)


@pytest.mark.parametrize("holey", [False, True])
@pytest.mark.parametrize("n", [256, 263])
def test_ell_steps_match_reference_kernels(n, holey):
    """B4 / B5's plain paths against the reference's kernels; the holey
    adjacency (PAD inside rows, an all-PAD warp) is stepped with its live
    widths handed in, as ``ops`` hands them."""
    ref, port = _pair("rmat", n, 8, 2)
    radj = ref.transpose().adj
    live = {}
    if holey:
        radj = _holey_adj(radj, n)
        live = {"live_width": bfs.ell_live_widths(_t(radj))}
    rng = np.random.default_rng(n)
    dist = np.full(n, INF, np.int32)
    dist[rng.choice(n, 5, replace=False)] = 0
    for level in (1, 2, 3):
        want = np.asarray(ref_bfs.bfs_step(
            jnp.asarray(radj), jnp.asarray(dist),
            jnp.array([level], jnp.int32), vl=64, interpret=True))
        got = bfs.bfs_step(_t(radj), _t(dist), level, vl=64, **live)
        assert got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)
        dist = want
    contrib = rng.random(n)
    consts = np.array([0.15 / n, 0.85, 0.01 / n])
    want = np.asarray(ref_pr.pagerank_step(
        jnp.asarray(radj), jnp.asarray(contrib), jnp.asarray(consts), vl=64,
        interpret=True))
    got = pagerank.pagerank_step(_t(radj), _t(contrib), _t(consts), vl=64,
                                 **live)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


def test_ell_steps_bound_handed_live_widths():
    """B4 / B5's walk bounds each handed-in live width to ``[0, width]``,
    on the plain path as in the kernels: width + 5 in every warp gives the
    true widths' result; -1 walks no slot, so that warp's nodes at INF
    stay there (BFS) and pull nothing (PageRank), the rest unchanged."""
    ref, _ = _pair("rmat", 263, 8, 2)
    radj = _t(ref.transpose().adj)
    n, width = radj.shape
    live = bfs.ell_live_widths(radj)
    rng = np.random.default_rng(8)
    dist = np.full(n, INF, np.int32)
    dist[rng.choice(n, 9, replace=False)] = 0
    dist = _t(dist)
    contrib = _t(rng.random(n))
    consts = _t(np.array([0.15 / n, 0.85, 0.01 / n]))
    want_b = bfs.bfs_step(radj, dist, 1)
    want_p = pagerank.pagerank_step(radj, contrib, consts)
    assert (want_b[64:96] == 1).any()           # the warp cut below has hits
    over = torch.full_like(live, width + 5)
    assert torch.equal(bfs.cut_to_live(radj, over), radj)
    assert torch.equal(bfs.bfs_step(radj, dist, 1, live_width=over), want_b)
    assert torch.equal(pagerank.pagerank_step(radj, contrib, consts,
                                              live_width=over), want_p)
    neg = live.clone()
    neg[2] = -1                                   # nodes 64 .. 95
    warp = (torch.arange(n) // 32) == 2
    got_b = bfs.bfs_step(radj, dist, 1, live_width=neg)
    assert torch.equal(got_b[warp], dist[warp])
    assert torch.equal(got_b[~warp], want_b[~warp])
    got_p = pagerank.pagerank_step(radj, contrib, consts, live_width=neg)
    assert torch.equal(got_p[warp], torch.full((32,), float(
        consts[0] + consts[1] * consts[2]), dtype=torch.float64))
    assert torch.equal(got_p[~warp], want_p[~warp])


@pytest.mark.parametrize("n", [1, 31, 32, 33, 263])
def test_bfs_frontier_matches_a_numpy_packing(n):
    """B4's frontier bitmap: bit j of word i is dist[32 i + j] == level - 1,
    the ragged last word padded with zeros."""
    rng = np.random.default_rng(n)
    dist = rng.choice(np.array([0, 1, 2, INF], np.int32), n)
    for level in (1, 2, 3):
        bits = np.pad(dist == level - 1, (0, -n % 32))
        want = np.packbits(bits, bitorder="little").view("<u4").view(np.int32)
        got = bfs.bfs_frontier_ref(_t(dist), level)
        assert got.dtype == torch.int32 and tuple(got.shape) == (-(-n // 32),)
        np.testing.assert_array_equal(got.numpy(), want)
        assert torch.equal(bfs.bfs_frontier(_t(dist), level), got)  # CPU


def test_ell_live_widths_match_a_numpy_count():
    """A graph's live widths (B6's, over the (1, width, n) view) against a
    numpy count, on a plain, a holey (PAD inside rows, an all-PAD warp)
    and a ragged (n not a multiple of 32) adjacency."""
    for n, seed in ((256, 1), (263, 2)):
        radj = _pair("uniform", n, 8, seed)[1].transpose().adj
        for adj in (radj, _holey_adj(radj, seed)):
            for t in (_t(adj), G.EllpackGraph(adj=adj, n_nodes=n)
                      .to_device("cpu")):                 # (width, n) storage
                got = bfs.ell_live_widths(t)
                assert got.dtype == torch.int32 and got.is_contiguous()
                np.testing.assert_array_equal(got.numpy(),
                                              _live_count_adj(adj))
    assert _live_count_adj(_holey_adj(radj, 2))[1] == 0     # the PAD warp
    with pytest.raises(ValueError, match="live widths of shape"):
        bfs.bfs_step(_t(radj), torch.zeros(n, dtype=torch.int32), 1,
                     live_width=torch.zeros(3, dtype=torch.int32))


@pytest.mark.parametrize("c", [8, 32])
@pytest.mark.parametrize("k", [None, 1, 3, 8])
def test_sell_steps_match_reference_kernels(c, k):
    ref, _ = _pair("rmat", 263, 8, 6)
    (radj_j, nodes_j), (radj, nodes) = _slabs(ref, c)
    n = ref.n_nodes
    rng = np.random.default_rng(c)
    sources = rng.choice(n, k or 1, replace=False)
    dist = _dist0(n, sources[0] if k is None else sources, k)
    for level in (1, 2):
        want = np.asarray(ref_bfs.bfs_step_sell(
            radj_j, nodes_j, jnp.asarray(dist), jnp.array([level], jnp.int32),
            interpret=True))
        got = bfs.bfs_step_sell(radj, nodes, _t(dist), level)
        assert got.shape == dist.shape
        assert np.array_equal(got.numpy(), want)
        dist = want
    shape = (n + 1,) if k is None else (n + 1, k)
    contrib = rng.random(shape)
    contrib[-1] = 0.0
    consts = rng.random((3,) if k is None else (3, k))
    want = np.asarray(ref_pr.pagerank_step_sell(
        radj_j, nodes_j, jnp.asarray(contrib), jnp.asarray(consts),
        interpret=True))
    got = pagerank.pagerank_step_sell(radj, nodes, _t(contrib), _t(consts))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)
    assert float(got[-1].abs().max()) == 0.0


def test_plain_gather_chunks_give_the_same_step(monkeypatch):
    """The plain versions walk the neighbour axis in chunks (a whole gather
    does not fit the card at full size); a one-column chunk agrees."""
    ref, _ = _pair("rmat", 256, 8, 7)
    _, (radj, nodes) = _slabs(ref, 8)
    dist = _t(_dist0(256, [3, 40], 2))
    contrib = torch.from_numpy(np.random.default_rng(0).random((257, 2)))
    consts = torch.tensor([[0.1, 0.2], [0.85, 0.9], [0.0, 0.01]],
                          dtype=torch.float64)
    whole_b = bfs.bfs_step_sell(radj, nodes, dist, 1)
    whole_p = pagerank.pagerank_step_sell(radj, nodes, contrib, consts)
    monkeypatch.setattr(sell_core, "PLAIN_GATHER_ELEMS", 1)
    assert torch.equal(bfs.bfs_step_sell(radj, nodes, dist, 1), whole_b)
    torch.testing.assert_close(
        pagerank.pagerank_step_sell(radj, nodes, contrib, consts), whole_p,
        rtol=RTOL, atol=0)


def _group_walk(bucket_adj, bucket_nodes, state, *, level=None,
                consts=None):
    """Kernel B3's group-form walk in plain PyTorch, as
    :func:`autotune.node_split` lays each bucket out: part p of a node
    walks slots w = p, p + parts, ... in ascending order (each lane of its
    group holding k_tile / group of the state columns, which the columns'
    independence leaves out of the arithmetic); BFS ORs the parts' hit
    masks, PageRank sums each part in order and adds the parts pairwise as
    the kernel's shared-memory tree does (stride parts / 2, then / 4, ...).
    Returns the new state and the largest ``parts`` used."""
    bfs_step = level is not None
    st = state if state.ndim == 2 else state[:, None]
    n = state.shape[0] - 1
    k_tile = sell_core.node_k_tile(st.shape[1])
    out = st.clone() if bfs_step else torch.zeros_like(st)
    most = 1
    for adj, nodes in zip(bucket_adj, bucket_nodes):
        s, c, w = adj.shape
        split = autotune.node_split(w, c, s, k_tile, state.element_size(),
                                    "bfs" if bfs_step else "pagerank")
        most = max(most, split.parts)
        a = adj.reshape(s * c, w).long()
        v = nodes.reshape(-1).long()
        parts = []
        for p in range(split.parts):
            acc = torch.zeros((s * c, st.shape[1]), dtype=st.dtype) \
                if not bfs_step else torch.zeros((s * c, st.shape[1]), dtype=torch.bool)
            for ww in range(p, w, split.parts):
                u = a[:, ww]
                ok = u != PAD
                g = st[u.clamp(min=0)]
                if bfs_step:
                    acc |= ok[:, None] & (g == level - 1)
                else:
                    acc[ok] += g[ok]
            parts.append(acc)
        while len(parts) > 1:
            half = len(parts) // 2
            parts = [parts[i] | parts[i + half] if bfs_step
                     else parts[i] + parts[i + half] for i in range(half)]
        real = v < n
        if bfs_step:
            mine = st[v[real]]
            out[v[real]] = torch.where((mine == INF) & parts[0][real], level,
                                       mine)
        else:
            cm = consts if consts.ndim == 2 else consts[:, None]
            out[v[real]] = cm[0] + cm[1] * (parts[0][real] + cm[2])
    return (out if state.ndim == 2 else out[:, 0]), most


@pytest.mark.parametrize("k", [None, 1, 3, 8, 32])
def test_group_split_walk_model_matches_both_references(k):
    """The model of B3's split walk on an rmat graph whose W = 1024 bucket
    is split (64 parts at k = 32): BFS exactly equal to the plain step and
    the reference's (interpret mode) over three levels, PageRank within
    rtol 1e-10 of both."""
    ref, _ = _pair("rmat", 600, 16, 2)
    (radj_j, nodes_j), (radj, nodes) = _slabs(ref, 8)
    assert max(a.shape[2] for a in radj) == 1024
    n = ref.n_nodes
    rng = np.random.default_rng(5)
    sources = rng.choice(n, k or 1, replace=False)
    dist = _dist0(n, sources[0] if k is None else sources, k)
    for level in (1, 2, 3):
        got, most = _group_walk(radj, nodes, _t(dist), level=level)
        assert most > 1
        want = bfs.bfs_step_sell_ref(radj, nodes, _t(dist), level)
        assert torch.equal(got, want)
        jax_want = np.asarray(ref_bfs.bfs_step_sell(
            radj_j, nodes_j, jnp.asarray(dist), jnp.array([level], jnp.int32),
            interpret=True))
        assert np.array_equal(got.numpy(), jax_want)
        dist = jax_want
    shape = (n + 1,) if k is None else (n + 1, k)
    contrib = rng.random(shape)
    contrib[-1] = 0.0
    consts = rng.random((3,) if k is None else (3, k))
    got, most = _group_walk(radj, nodes, _t(contrib), consts=_t(consts))
    assert most > 1
    torch.testing.assert_close(
        got, pagerank.pagerank_step_sell_ref(radj, nodes, _t(contrib),
                                             _t(consts)), rtol=RTOL, atol=0)
    want = np.asarray(ref_pr.pagerank_step_sell(
        radj_j, nodes_j, jnp.asarray(contrib), jnp.asarray(consts),
        interpret=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


# ---------------------------------------------------------------------------
# Full drives
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("kind,n", [("rmat", 256), ("uniform", 263)])
def test_bfs_sell_matches_reference_scalar_and_batched(kind, n):
    ref, port = _pair(kind, n, 8, 11)
    (radj_j, nodes_j), (radj, nodes) = _slabs(ref, 32)
    for source in (5, [0, 7, 7, n - 1]):
        want = np.asarray(ref_bfs.bfs_sell(radj_j, nodes_j, n, source,
                                           interpret=True))
        got = bfs.bfs_sell(radj, nodes, n, source)
        assert got.dtype == torch.int32 and got.shape == want.shape
        assert np.array_equal(got.numpy(), want)
        for j, s in enumerate(np.atleast_1d(source)):
            col = got.numpy() if np.ndim(source) == 0 else got.numpy()[:, j]
            assert np.array_equal(col, G.bfs_reference(port, int(s)))
    assert torch.equal(bfs.bfs_sell_ref(radj, nodes, n, [0, 7]),
                       bfs.bfs_sell(radj, nodes, n, [0, 7]))
    with pytest.raises(ValueError, match="out of range"):
        bfs.bfs_sell(radj, nodes, n, [0, n])


@pytest.mark.parametrize("n", [256, 263])
def test_pagerank_sell_matches_reference_with_per_column_budgets(n):
    ref, port = _pair("rmat", n, 8, 12)
    (radj_j, nodes_j), (radj, nodes) = _slabs(ref, 8)
    deg = ref.out_degree.astype(np.float64)
    for damping, iters in ((0.85, 6), ([0.85, 0.9, 0.8, 0.95], [6, 2, 4, 1])):
        want = np.asarray(ref_pr.pagerank_sell(
            radj_j, nodes_j, jnp.asarray(deg), n, damping=damping,
            iters=iters, interpret=True))
        got = pagerank.pagerank_sell(radj, nodes, _t(deg), n,
                                     damping=damping, iters=iters)
        assert got.dtype == torch.float64 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)
    # a frozen column equals that configuration run alone, and the host
    # reference
    alone = pagerank.pagerank_sell(radj, nodes, _t(deg), n, damping=0.9,
                                   iters=2)
    np.testing.assert_allclose(got[:, 1].numpy(), alone.numpy(), rtol=RTOL)
    np.testing.assert_allclose(alone.numpy(), G.pagerank_reference(port, 0.9, 2),
                               rtol=RTOL)
    torch.testing.assert_close(
        pagerank.pagerank_sell_ref(radj, nodes, _t(deg), n, damping=[0.8, 0.9],
                                   iters=3),
        pagerank.pagerank_sell(radj, nodes, _t(deg), n, damping=[0.8, 0.9],
                               iters=3), rtol=RTOL, atol=0)
    with pytest.raises(ValueError, match="equal-length"):
        pagerank.broadcast_configs([0.8, 0.9], [1, 2, 3])


def test_ell_drives_match_reference():
    ref, port = _pair("uniform", 263, 6, 13)
    radj = ref.transpose().adj
    deg = ref.out_degree.astype(np.float64)
    want = np.asarray(ref_bfs.bfs(jnp.asarray(radj), 4, vl=64, interpret=True))
    got = bfs.bfs(_t(radj), 4, vl=64)
    assert np.array_equal(got.numpy(), want)
    assert torch.equal(bfs.bfs_ref(_t(radj), 4), got)
    want = np.asarray(ref_pr.pagerank(jnp.asarray(radj), jnp.asarray(deg),
                                      damping=0.9, iters=5, vl=64,
                                      interpret=True))
    got = pagerank.pagerank(_t(radj), _t(deg), damping=0.9, iters=5, vl=64)
    np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)
    np.testing.assert_allclose(got.numpy(), G.pagerank_reference(port, 0.9, 5),
                               rtol=RTOL)


# ---------------------------------------------------------------------------
# ops front door, both layouts
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("layout", ["ell", "sell"])
def test_ops_bfs_and_pagerank_match_reference(layout):
    ref, port = _pair("rmat", 263, 8, 14)
    rspec = RefExecSpec(layout=layout, vl=16, interpret=True)
    spec = dataclasses.replace(CPU, layout=layout, vl=16)
    for source in (3, [3, 100, 262]):
        want = np.asarray(ref_ops.bfs(ref, source, spec=rspec))
        got = ops.bfs(port, source, spec=spec)
        assert got.device.type == "cpu" and got.dtype == torch.int32
        assert np.array_equal(got.numpy(), want)
    for damping, iters in ((0.85, 5), ([0.85, 0.9], [5, 3])):
        want = np.asarray(ref_ops.pagerank(ref, damping=damping, iters=iters,
                                           spec=rspec))
        got = ops.pagerank(port, damping=damping, iters=iters, spec=spec)
        assert got.dtype == torch.float64 and got.shape == want.shape
        np.testing.assert_allclose(got.numpy(), want, rtol=RTOL, atol=0)


def test_ops_graph_prep_happens_once_per_graph(monkeypatch):
    calls = {"n": 0}
    real = G.EllpackGraph.transpose

    def counting(self):
        calls["n"] += 1
        return real(self)

    monkeypatch.setattr(G.EllpackGraph, "transpose", counting)
    _, port = _pair("uniform", 200, 6, 15)
    for layout in ("ell", "sell", "ell"):
        spec = dataclasses.replace(CPU, layout=layout, vl=8)
        ops.bfs(port, 0, spec=spec)
        ops.pagerank(port, iters=2, spec=spec)
    assert calls["n"] == 1
    key = id(port)
    assert key in ops._PREPARED_GRAPHS
    del port
    assert key not in ops._PREPARED_GRAPHS
    with pytest.raises(ValueError, match="unknown layout"):
        ops.bfs(_pair()[1], 0, spec=dataclasses.replace(CPU, layout="csr"))
    with pytest.raises(TypeError, match="EllpackGraph"):
        ops.bfs(object(), 0, spec=CPU)


# ---------------------------------------------------------------------------
# Preflight: what the CUDA kernels cannot take is refused before a launch
# ---------------------------------------------------------------------------


def test_ops_computes_live_widths_once_per_graph_and_device(monkeypatch):
    """``ops`` computes an ELLPACK graph's live widths beside its upload,
    once per graph and device, and plans them; it hands them to every
    drive on the card and none on the CPU, whose plain step walks every
    slot; the SELL layout never computes them."""
    calls = {"n": 0}
    real = bfs.ell_live_widths

    def counting(adj):
        calls["n"] += 1
        return real(adj)

    monkeypatch.setattr(bfs, "ell_live_widths", counting)
    handed = []
    real_bfs, real_pr = bfs.bfs, pagerank.pagerank
    monkeypatch.setattr(bfs, "bfs", lambda *a, **kw: (
        handed.append(kw["live_width"]), real_bfs(*a, **kw))[1])
    monkeypatch.setattr(pagerank, "pagerank", lambda *a, **kw: (
        handed.append(kw["live_width"]), real_pr(*a, **kw))[1])
    _, port = _pair("uniform", 200, 6, 19)
    for layout in ("sell", "ell", "ell"):
        spec = dataclasses.replace(CPU, layout=layout, vl=8)
        ops.bfs(port, 0, spec=spec)
        ops.bfs(port, [0, 5], spec=spec)
        ops.pagerank(port, iters=2, spec=spec)
    assert len(handed) == 8 and all(h is None for h in handed)
    _, (_, live), _ = ops._prepared_graph(
        port, dataclasses.replace(CPU, vl=8), torch.device("cpu"),
        plan_bfs_ell)
    assert calls["n"] == 1
    want = _live_count_adj(port.transpose().adj)
    np.testing.assert_array_equal(live.numpy(), want)
    meta = ops._PREPARED_GRAPHS[id(port)]["live"]
    assert (meta.n, meta.lo, meta.hi) == (len(want), want.min(), want.max())


def test_graph_plans_mirror_the_kernel_launch():
    _, port = _pair("rmat", 300, 8, 16)
    slabs = G.graph_to_sell_slabs(port.transpose(), c=32)
    meta = SlabMeta.from_slabs(slabs, check_bounds=True)
    assert meta.kind == "graph" and meta.val_dtype is None
    assert meta.idx_max < 300 and meta.map_max == 300 and meta.map_min == 0
    for k, want_y in ((1, 1), (6, 3), (32, 1), (64, 2)):
        k_tile = sell_core.node_k_tile(k)
        for plan, itemsize, combine in (
                (plan_bfs_sell(meta, k=k), 4, "bfs"),
                (plan_pagerank_sell(meta, k=k), 8, "pagerank")):
            assert plan.ok and plan.n_launches == len(slabs.widths)
            for b, a in zip(plan.blocks, slabs.bucket_adj):
                s, c, w = a.shape
                split = autotune.node_split(w, c, s, k_tile, itemsize,
                                            combine)
                assert b.grid == (-(-s * c // split.nodes), want_y)
                assert b.block == (split.threads,)
                assert b.smem_bytes == split.smem_bytes
                assert split.threads <= 1024
                assert split.group == max(1, k_tile * itemsize // 16)
    # ELLPACK: B4 is the frontier pass, then the walk; B5 the walk alone
    threads = autotune.ELL_NODE_BLOCK_THREADS
    grid = -(-300 // threads)
    for adj, plan_ell, launches in ((port.transpose().adj, plan_bfs_ell, 2),
                                    (port.adj, plan_pagerank_ell, 1)):
        live = LiveWidthMeta.from_array(_live_count_adj(adj))
        ell = plan_ell(SlabMeta.from_ell(adj, 300, check_bounds=True),
                       live=live)
        assert ell.ok and ell.n_launches == launches
        assert all(b.block == (threads,) for b in ell.blocks)
        walk = ell.blocks[-1]
        assert walk.grid == (grid, 1)
        assert ("live", (10,), "int32") in walk.operands
        assert ("adj", (adj.shape[1], 300), "int32") in walk.operands
    front = plan_bfs_ell(SlabMeta.from_ell(port.adj, 300)).blocks[0]
    assert front.label == "frontier" and front.grid == (grid,)
    assert front.operands == (("state", (300,), "int32"),
                              ("frontier", (10,), "int32"))


def test_graph_plans_reject_what_the_kernels_cannot_take():
    _, port = _pair("rmat", 300, 8, 17)
    slabs = G.graph_to_sell_slabs(port.transpose(), c=32)
    meta = SlabMeta.from_slabs(slabs, check_bounds=True)
    oob = dataclasses.replace(meta, idx_max=300)
    with pytest.raises(LaunchPlanError, match="out of bounds for n_nodes"):
        plan_bfs_sell(oob).raise_if_invalid()
    with pytest.raises(LaunchPlanError, match="below the PAD"):
        plan_pagerank_sell(dataclasses.replace(meta, idx_min=-2)
                           ).raise_if_invalid()
    with pytest.raises(LaunchPlanError, match="beyond the dump slot"):
        plan_bfs_sell(dataclasses.replace(meta, map_max=301)).raise_if_invalid()
    # the kernels have a float64 and a float32 form, and no other
    assert plan_pagerank_sell(meta, dtype="float32").ok
    with pytest.raises(LaunchPlanError, match="float64"):
        plan_pagerank_sell(meta, dtype="float16").raise_if_invalid()
    with pytest.raises(LaunchPlanError, match="grid.y"):
        plan_bfs_sell(meta, k=65_537).raise_if_invalid()
    with pytest.raises(LaunchPlanError, match="not a power of two"):
        plan_bfs_sell(dataclasses.replace(meta, widths=(3,) + meta.widths[1:])
                      ).raise_if_invalid()
    ell = SlabMeta.from_ell(port.adj, 300, check_bounds=True)
    assert plan_bfs_ell(ell).ok
    w = port.adj.shape[1]
    for plan_ell in (plan_bfs_ell, plan_pagerank_ell):
        with pytest.raises(LaunchPlanError, match="live widths hold 9"):
            plan_ell(ell, live=LiveWidthMeta(9, 0, w)).raise_if_invalid()
        with pytest.raises(LaunchPlanError, match="outside"):
            plan_ell(ell, live=LiveWidthMeta(10, 0, w + 1)).raise_if_invalid()
        with pytest.raises(LaunchPlanError, match="outside"):
            plan_ell(ell, live=LiveWidthMeta(10, -1, w)).raise_if_invalid()
    with pytest.raises(LaunchPlanError, match="one state column"):
        plan_bfs_sell(ell, k=2).raise_if_invalid()
    mslabs = F.csr_to_sell_slabs(F.random_csr(50, 50, 3.0, seed=0), c=8)
    with pytest.raises(LaunchPlanError, match="needs graph adjacency"):
        plan_bfs_sell(SlabMeta.from_slabs(mslabs)).raise_if_invalid()


def test_out_of_range_ids_are_refused_before_any_gather():
    """CUDA does not clamp a gather the way JAX does, so a corrupt
    neighbour id or node map must stop at the preflight."""
    _, port = _pair("uniform", 120, 4, 18)
    bad_adj = port.adj.copy()
    bad_adj[5, 0] = 120
    bad = G.EllpackGraph(adj=bad_adj, n_nodes=120)
    for layout in ("ell", "sell"):
        spec = dataclasses.replace(CPU, layout=layout, vl=8)
        with pytest.raises(LaunchPlanError, match="out of bounds"):
            ops.bfs(bad, 0, spec=spec)
        with pytest.raises(LaunchPlanError, match="out of bounds"):
            ops.pagerank(bad, spec=spec)
    slabs = G.graph_to_sell_slabs(port.transpose(), c=8)
    adj = tuple(a.copy() for a in slabs.bucket_adj)
    adj[-1][0, 0, 0] = -7
    meta = SlabMeta.from_slabs(dataclasses.replace(slabs, bucket_adj=adj),
                               check_bounds=True)
    with pytest.raises(LaunchPlanError, match="below the PAD"):
        plan_bfs_sell(meta).raise_if_invalid()
    nodes = tuple(m.copy() for m in slabs.bucket_nodes)
    nodes[0][0, 0] = -1
    meta = SlabMeta.from_slabs(dataclasses.replace(slabs, bucket_nodes=nodes),
                               check_bounds=True)
    with pytest.raises(LaunchPlanError, match="lane map entry -1"):
        plan_pagerank_sell(meta).raise_if_invalid()


def test_wrappers_check_arguments_and_never_fall_back():
    _, port = _pair("rmat", 128, 4, 19)
    adj, nodes = G.graph_to_sell_slabs(port.transpose(), c=8).to_device("cpu")
    dist = _t(_dist0(128, 0))
    with pytest.raises(TypeError, match="int32"):
        bfs.bfs_step_sell(adj, nodes, dist.to(torch.int64), 1)
    with pytest.raises(ValueError, match="node map"):
        bfs.bfs_step_sell(adj, nodes[:-1], dist, 1)
    with pytest.raises(TypeError, match="float64"):
        pagerank.pagerank_step_sell(adj, nodes, torch.zeros(129),
                                    torch.zeros(3, dtype=torch.float64))
    with pytest.raises(ValueError, match="consts"):
        pagerank.pagerank_step_sell(adj, nodes,
                                    torch.zeros(129, dtype=torch.float64),
                                    torch.zeros(2, dtype=torch.float64))
    # a tensor on neither the CPU nor a card is refused, not computed
    meta_dist = torch.empty(129, dtype=torch.int32, device="meta")
    with pytest.raises(RuntimeError, match="CUDA kernel and a CPU reference"):
        bfs.bfs_step_sell(tuple(a.to("meta") for a in adj),
                          tuple(m.to("meta") for m in nodes), meta_dist, 1)
    with pytest.raises(RuntimeError, match="CUDA kernel and a CPU reference"):
        bfs.bfs_frontier(meta_dist, 1)
    radj = port.to_device("meta")
    with pytest.raises(RuntimeError, match="CUDA kernel and a CPU reference"):
        pagerank.pagerank_step(radj, torch.empty(128, dtype=torch.float64,
                                                 device="meta"),
                               torch.empty(3, dtype=torch.float64,
                                           device="meta"))


def test_graph_kernels_are_registered_for_the_build():
    from repro_torch.kernels import cuda_lib

    source, fns = cuda_lib.KERNELS["graph_step"]
    assert (cuda_lib.CSRC / source).exists()
    assert {"repro_bfs_sell_bucket", "repro_pagerank_sell_bucket",
            "repro_bfs_frontier", "repro_bfs_ell_step",
            "repro_pagerank_ell_step"} <= set(fns)
    assert set(bfs.KERNEL_LAUNCHES) == {"bfs_step_sell", "bfs_step",
                                        "bfs_frontier"}
    assert set(pagerank.KERNEL_LAUNCHES) == {
        "pagerank_step_sell", "pagerank_step", "pagerank_step_sell_fp32",
        "pagerank_step_fp32"}
