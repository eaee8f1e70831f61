"""Parity of the port's sharded SELL execution (``repro_torch.kernels
.sell_shard``, the shard layouts of ``repro_torch.sparse.formats`` and
``repro_torch.graphs.gen``, ``ExecSpec.placement`` through ``ops``, a
``KernelRegistry(mesh=...)`` and the service) and of its float32 PageRank
with the JAX reference.

The reference runs its serial fold (``mesh=None``: the same per-shard
kernels and combines folded on one device, which its own tests hold
bit-identical to its mesh path), its Pallas kernels in interpret mode.
The port runs on a mesh naming the CPU N times (``("cpu",) * N``, the
counterpart of the reference's forced host device count), where every
shard takes its plain PyTorch version.  Tolerance: 1e-10 (fp64, only the
summation order differs), BFS distances exactly equal; the port's mesh
path ``torch.equal`` to its own serial fold, and for SpMM and BFS to the
unsharded port (PageRank at the tolerance: the plain step's reduction
order follows the bucket's shape).
Float32 PageRank: the reference runs under ``jax.enable_x64(False)``,
where it computes in float32; ranks within 1e-4 x max|rank| a column (the
port's fp32 scale: float32 sums in another order), and the sharded drives
within 1e-6 x max|rank| of the unsharded port's.
"""
import dataclasses
import gc

import numpy as np
import pytest
import torch

import jax

from repro.core import autotune as ref_autotune
from repro.graphs import gen as RG
from repro.kernels import ops as ref_ops
from repro.kernels import sell_shard as ref_shard
from repro.kernels.execspec import ExecSpec as RefExecSpec
from repro.service.tunecache import TuneCache as RefTuneCache
from repro.sparse import formats as RF
from repro_torch.analysis import (
    LaunchPlanError,
    SlabMeta,
    plan_bfs_sell,
    plan_pagerank_ell,
    plan_pagerank_sell,
    plan_spmm_sell_sharded,
)
from repro_torch.core import autotune
from repro_torch.graphs import gen as G
from repro_torch.kernels import ops, sell_shard, uploads
from repro_torch.kernels.execspec import ExecSpec
from repro_torch.service import KernelRegistry, KernelService
from repro_torch.service.tunecache import TuneCache
from repro_torch.sparse import formats as F

TOL = 1e-10
FP32 = 1e-4
#: float32 ranks of the sharded drives against the unsharded port's, x
#: max|rank| a column: the same float32 sums, grouped by other buckets
#: (a few float32 ulps)
SHARD_FP32 = 1e-6
CPU = ExecSpec(device="cpu")
SHARDS = (2, 3, 4)


def _mesh(n):
    return ("cpu",) * n


def _t(a) -> torch.Tensor:
    return torch.from_numpy(np.array(a))


def _np(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()


def _csr_pair(n=131, avg=5.0, seed=1, skew=1.5):
    return (RF.random_csr(n, n, avg, seed=seed, skew=skew),
            F.random_csr(n, n, avg, seed=seed, skew=skew))


def _graph_pair(kind="rmat", n=257, deg=8, seed=3):
    make = {"rmat": "rmat_graph", "uniform": "random_graph"}[kind]
    return (getattr(RG, make)(n, deg, seed=seed),
            getattr(G, make)(n, deg, seed=seed))


def _empty_bucket_csr(module):
    """One row touching every column and a tail of one-entry rows: the
    union bucket set holds a width some shards never fill, so those carry
    PAD-only slices (the reference's ``tests/test_sharded.py`` case)."""
    n = 12
    indptr, indices, data = [0], [], []
    for i in range(n):
        cols = np.arange(n) if i == 0 else np.array([i])
        indices.extend(cols.tolist())
        data.extend(1.0 + 0.1 * i for _ in cols)
        indptr.append(len(indices))
    return module.CSRMatrix(np.asarray(indptr, np.int64),
                            np.asarray(indices, np.int32),
                            np.asarray(data, np.float64), n)


def _assert_same_layout(port, ref, fields) -> None:
    for name in fields:
        a, b = getattr(port, name), getattr(ref, name)
        if isinstance(b, tuple):
            assert len(a) == len(b), name
            for x, y in zip(a, b):
                assert x.dtype == y.dtype and np.array_equal(x, y), name
        elif isinstance(b, np.ndarray):
            assert a.dtype == b.dtype and np.array_equal(a, b), name
        else:
            assert a == b, name


MATRIX_FIELDS = ("bucket_cols", "bucket_vals", "bucket_rows", "row_starts",
                 "row_counts", "col_starts", "window_cols", "boundary_cols",
                 "n_rows", "n_cols", "nnz", "sigma")
GRAPH_FIELDS = ("bucket_adj", "bucket_nodes", "node_starts", "node_counts",
                "n_nodes", "sigma")


# ---------------------------------------------------------------------------
# Shard layouts: array for array
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("lengths", [
    [40, 1, 1, 1, 1, 1, 1, 39], [0, 0, 0, 5, 0, 0], [3] * 10, [7], []])
@pytest.mark.parametrize("n_shards", SHARDS)
def test_shard_row_ranges_match_reference(lengths, n_shards):
    lengths = np.asarray(lengths, np.int64)
    got = F.shard_row_ranges(lengths, n_shards)
    assert got == RF.shard_row_ranges(lengths, n_shards)
    assert got[0][0] == 0 and got[-1][1] == len(lengths)
    assert all(b == c for (_, b), (c, _) in zip(got, got[1:]))


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("case", ["skewed", "uneven", "empty-buckets"])
def test_shard_slabs_match_reference(case, n_shards):
    if case == "empty-buckets":
        ref, port, c = _empty_bucket_csr(RF), _empty_bucket_csr(F), 4
    elif case == "uneven":
        (ref, port), c = _csr_pair(97, 5.0, seed=3, skew=1.5), 16
    else:
        (ref, port), c = _csr_pair(131, 6.0, seed=1, skew=2.0), 8
    got = F.shard_slabs(F.csr_to_sell_slabs(port, c=c), n_shards)
    want = RF.shard_slabs(RF.csr_to_sell_slabs(ref, c=c), n_shards)
    _assert_same_layout(got, want, MATRIX_FIELDS)
    assert (got.rows_max, got.widths, got.slices_per_shard) == \
        (want.rows_max, want.widths, want.slices_per_shard)
    x = np.random.default_rng(n_shards).standard_normal(port.n_cols)
    np.testing.assert_allclose(got.matvec(x), port.matvec(x), rtol=TOL,
                               atol=TOL)
    if case == "empty-buckets" and n_shards == 4:
        # a shard that owns no row of the widest bucket carries PAD only
        assert any((cols[d] == F.PAD).all() for cols in got.bucket_cols
                   for d in range(n_shards))


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("kind,n,deg,seed,c", [
    ("rmat", 257, 8, 3, 16), ("uniform", 90, 4, 2, 16), ("rmat", 300, 16, 7, 8)])
def test_shard_graph_slabs_match_reference(kind, n, deg, seed, c, n_shards):
    ref, port = _graph_pair(kind, n, deg, seed)
    got = G.shard_graph_slabs(port.transpose(), c=c, n_shards=n_shards)
    want = RG.shard_graph_slabs(ref.transpose(), c=c, n_shards=n_shards)
    _assert_same_layout(got, want, GRAPH_FIELDS)
    assert got.widths == want.widths
    assert got.slices_per_shard == want.slices_per_shard


# ---------------------------------------------------------------------------
# The four drives: mesh path == serial fold == unsharded, against the
# reference's serial fold
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("k", [1, 4, 32])
def test_spmm_sharded_mesh_equals_fold_and_unsharded(n_shards, k):
    _, port = _csr_pair(131, 5.0, seed=1, skew=1.5)
    x = _t(np.random.default_rng(k).standard_normal((131, k)))
    slabs = F.csr_to_sell_slabs(port, c=16)
    sharded = F.shard_slabs(slabs, n_shards)
    want = ops.spmm(slabs, x, spec=dataclasses.replace(CPU, vl=16, k_block=4))
    got = sell_shard.spmm_sell_sharded(sharded, x, mesh=_mesh(n_shards),
                                       k_block=4)
    assert torch.equal(got, sell_shard.spmm_sell_sharded(sharded, x,
                                                         k_block=4))
    assert torch.equal(got, want)
    assert torch.equal(sell_shard.spmm_sell_rhs_sharded(
        slabs, x, mesh=_mesh(n_shards), k_block=4), want)


def test_ops_and_the_sharded_drives_share_one_upload_memo():
    """An operand that ``ops`` and the RHS-sharded drive both run is
    uploaded to a device once; a shard layout's uploads sit in the same
    memo, one a (shard, device), and go with the layout."""
    _, port = _csr_pair(131, 5.0, seed=2, skew=1.5)
    slabs = F.csr_to_sell_slabs(port, c=16)
    x = _t(np.random.default_rng(2).standard_normal((131, 32)))
    cpu = torch.device("cpu")
    ops.spmm(slabs, x, spec=dataclasses.replace(CPU, vl=16, k_block=4))
    whole = uploads.ENTRIES[id(slabs)][cpu]
    sell_shard.spmm_sell_rhs_sharded(slabs, x, mesh=_mesh(4), k_block=4)
    assert uploads.ENTRIES[id(slabs)][cpu] is whole
    assert ops._PREPARED is uploads.ENTRIES
    sharded = F.shard_slabs(slabs, 3)
    sell_shard.upload(sharded, _mesh(3))
    key = id(sharded)
    assert set(uploads.ENTRIES[key]) == {(d, cpu) for d in range(3)}
    y = sell_shard.spmm_sell_sharded(sharded, x, mesh=_mesh(3), k_block=4)
    assert set(uploads.ENTRIES[key]) == {(d, cpu) for d in range(3)}
    assert torch.equal(y, ops.spmm(slabs, x, spec=dataclasses.replace(
        CPU, vl=16, k_block=4)))
    del sharded
    gc.collect()
    assert key not in uploads.ENTRIES


def test_spmm_sell_sharded_and_rhs_sharded_match_reference():
    """The reference's serial folds (interpret mode) at three shards: the
    row-sharded drive on a skewed operand, and on one whose union buckets
    leave a shard PAD-only; the RHS-sharded drive at k = 30."""
    ref, port = _csr_pair(97, 5.0, seed=3, skew=1.5)
    x = np.random.default_rng(4).standard_normal((97, 4))
    got = sell_shard.spmm_sell_sharded(
        F.shard_slabs(F.csr_to_sell_slabs(port, c=16), 3), _t(x),
        mesh=_mesh(3), k_block=4)
    want = ref_shard.spmm_sell_sharded(
        RF.shard_slabs(RF.csr_to_sell_slabs(ref, c=16), 3), x, mesh=None,
        w_block=8, k_block=4)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=TOL, atol=TOL)
    port, ref = _empty_bucket_csr(F), _empty_bucket_csr(RF)
    x = np.random.default_rng(0).standard_normal((12, 1))
    got = sell_shard.spmm_sell_sharded(
        F.shard_slabs(F.csr_to_sell_slabs(port, c=4), 4), _t(x),
        mesh=_mesh(4), k_block=1)
    want = ref_shard.spmm_sell_sharded(
        RF.shard_slabs(RF.csr_to_sell_slabs(ref, c=4), 4), x, mesh=None,
        w_block=4, k_block=1)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_np(got)[:, 0], port.matvec(x[:, 0]),
                               rtol=TOL, atol=TOL)
    ref, port = _csr_pair(64, 4.0, seed=6, skew=1.0)
    x = np.random.default_rng(6).standard_normal((64, 30))
    got = sell_shard.spmm_sell_rhs_sharded(
        F.csr_to_sell_slabs(port, c=16), _t(x), mesh=_mesh(3), k_block=4)
    want = ref_shard.spmm_sell_rhs_sharded(
        RF.csr_to_sell_slabs(ref, c=16), x, mesh=None, w_block=8, k_block=4)
    np.testing.assert_allclose(_np(got), np.asarray(want), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("n_shards", SHARDS)
@pytest.mark.parametrize("kind,n,deg,c", [("rmat", 257, 8, 16),
                                          ("uniform", 90, 4, 16)])
def test_graph_drives_mesh_equals_fold_and_unsharded(kind, n, deg, c,
                                                     n_shards):
    _, port = _graph_pair(kind, n, deg, 3)
    sg = G.shard_graph_slabs(port.transpose(), c=c, n_shards=n_shards)
    spec = dataclasses.replace(CPU, layout="sell", vl=c)
    deg_t = _t(port.out_degree.astype(np.float64))
    for source in (7, [0, 5, n - 1]):
        got = sell_shard.bfs_sell_sharded(sg, source, mesh=_mesh(n_shards))
        assert torch.equal(got, sell_shard.bfs_sell_sharded(sg, source,
                                                            device="cpu"))
        assert torch.equal(got, ops.bfs(port, source, spec=spec))
    for damping, iters in ((0.85, 9), ([0.85, 0.9, 0.7], [9, 4, 9])):
        for dtype in (torch.float64, torch.float32):
            got = sell_shard.pagerank_sell_sharded(
                sg, deg_t, mesh=_mesh(n_shards), damping=damping,
                iters=iters, dtype=dtype)
            assert torch.equal(got, sell_shard.pagerank_sell_sharded(
                sg, deg_t, damping=damping, iters=iters, dtype=dtype,
                device="cpu"))
            # the plain step sums each neighbour chunk with torch's own
            # reduction, whose order follows the bucket's shape: against
            # the unsharded layout at the dtype's tolerance (the kernels
            # walk w in order, and are torch.equal there on the card)
            want = ops.pagerank(port, damping=damping, iters=iters,
                                spec=spec, dtype=dtype)
            if dtype == torch.float64:
                torch.testing.assert_close(got, want, rtol=TOL, atol=0)
            else:
                _fp32_close(got, _np(want), "sharded fp32 vs unsharded",
                            SHARD_FP32)


@pytest.fixture(scope="module")
def small_graph():
    """A 64-node uniform graph (one union bucket at C = 32): the
    reference's interpret-mode graph drives take ~0.2 s a bucket a shard a
    step, so its sharded drives run here once each."""
    return _graph_pair("uniform", 64, 6, 3)


def test_graph_drives_sharded_match_reference(small_graph):
    ref, port = small_graph
    sg = G.shard_graph_slabs(port.transpose(), c=32, n_shards=3)
    rsg = RG.shard_graph_slabs(ref.transpose(), c=32, n_shards=3)
    got = sell_shard.bfs_sell_sharded(sg, [0, 5], mesh=_mesh(3))
    want = np.asarray(ref_shard.bfs_sell_sharded(rsg, [0, 5], mesh=None))
    assert np.array_equal(_np(got), want)
    deg = port.out_degree.astype(np.float64)
    got = sell_shard.pagerank_sell_sharded(
        sg, deg, mesh=_mesh(3), damping=[0.85, 0.9], iters=[5, 3])
    want = np.asarray(ref_shard.pagerank_sell_sharded(
        rsg, deg, mesh=None, damping=[0.85, 0.9], iters=[5, 3]))
    np.testing.assert_allclose(_np(got), want, rtol=TOL, atol=0)


def test_mesh_shape_and_device_refusals():
    _, port = _csr_pair()
    sharded = F.shard_slabs(F.csr_to_sell_slabs(port, c=16), 3)
    with pytest.raises(ValueError, match="partitioned into 3 shards"):
        sell_shard.spmm_sell_sharded(sharded, torch.zeros(131, 1),
                                     mesh=_mesh(2))
    with pytest.raises(ValueError, match="unsupported device meta"):
        sell_shard.device_mesh(2, ("cpu", "meta"))
    with pytest.raises(ValueError, match="names 1"):
        sell_shard.device_mesh(2, ("cpu",))
    assert len(sell_shard.device_mesh(1)) == 0
    assert sell_shard.device_mesh(3, _mesh(4)).devices == \
        (torch.device("cpu"),) * 3
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="only .* CUDA device"):
            sell_shard.device_mesh(2)
        with pytest.raises(ValueError, match="only .* CUDA device"):
            ExecSpec(placement=max(2, torch.cuda.device_count() + 1)) \
                .resolved_placement()


# ---------------------------------------------------------------------------
# ops with a placement, the registry and the service with a mesh
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("n_devices", [2, 4])
def test_ops_with_placement_match_unsharded(n_devices):
    _, port = _csr_pair(131, 5.0, seed=1, skew=1.5)
    rng = np.random.default_rng(0)
    one = dataclasses.replace(CPU, vl=16)
    placed = ExecSpec(vl=16, placement=_mesh(n_devices))
    for x in (rng.standard_normal(131), rng.standard_normal((131, 8)),
              rng.standard_normal((131, 32))):
        got = ops.spmv(port, x, spec=placed)
        assert got.device.type == "cpu"
        assert torch.equal(got, ops.spmv(port, x, spec=one))
    _, g = _graph_pair("uniform", 90, 4, 2)
    gone = dataclasses.replace(CPU, layout="sell", vl=16)
    gplaced = ExecSpec(layout="sell", vl=16, placement=_mesh(n_devices))
    assert torch.equal(ops.bfs(g, [0, 4], spec=gplaced),
                       ops.bfs(g, [0, 4], spec=gone))
    torch.testing.assert_close(
        ops.pagerank(g, damping=[0.85, 0.9], spec=gplaced),
        ops.pagerank(g, damping=[0.85, 0.9], spec=gone), rtol=TOL, atol=0)


def test_ops_placement_refusals_match_reference():
    """The reference's refusals, word for word in meaning: streaming with
    a placement, ELLPACK operands and ELLPACK-layout graphs with one, and
    the FFT with one; a placement of one device is the unsharded call."""
    ref, port = _csr_pair()
    x = np.ones(131)
    _, g = _graph_pair("uniform", 90, 4, 2)
    mesh = _mesh(2)
    cases = [
        (lambda: ops.spmv(port, x, spec=ExecSpec(vl=16, placement=mesh,
                                                 mode="stream")),
         lambda: ref_ops.spmv(ref, x, spec=RefExecSpec(
             vl=16, placement=2, mode="stream")), "mode='stream'"),
        (lambda: ops.spmv(F.csr_to_ellpack(port, c=16), x,
                          spec=ExecSpec(vl=16, placement=mesh)),
         lambda: ref_ops.spmv(RF.csr_to_ellpack(ref, c=16), x,
                              spec=RefExecSpec(vl=16, placement=2)),
         "SELL slab layout"),
        (lambda: ops.bfs(g, 0, spec=ExecSpec(vl=16, placement=mesh)),
         lambda: ref_ops.bfs(RG.random_graph(90, 4, seed=2), 0,
                             spec=RefExecSpec(vl=16, placement=2)),
         "layout='sell'"),
        (lambda: ops.pagerank(g, spec=ExecSpec(vl=16, placement=mesh)),
         lambda: ref_ops.pagerank(RG.random_graph(90, 4, seed=2),
                                  spec=RefExecSpec(vl=16, placement=2)),
         "layout='sell'"),
        (lambda: ops.fft(np.ones(8), spec=ExecSpec(placement=mesh)),
         lambda: ref_ops.fft(np.ones(8), spec=RefExecSpec(placement=2)),
         "no sharded execution path"),
    ]
    for port_call, ref_call, match in cases:
        with pytest.raises(ValueError, match=match):
            port_call()
        with pytest.raises(ValueError, match=match):
            ref_call()
    torch.testing.assert_close(
        ops.spmv(port, x, spec=dataclasses.replace(CPU, vl=16, placement=1)),
        ops.spmv(port, x, spec=dataclasses.replace(CPU, vl=16)), rtol=0,
        atol=0)
    with pytest.raises(TypeError, match="placement must be"):
        ExecSpec(placement="cpu")
    # a device of another type than the mesh's: no GPU here (RuntimeError),
    # a mismatch on a machine with one (ValueError)
    with pytest.raises((RuntimeError, ValueError)):
        ops.spmv(port, x, spec=ExecSpec(vl=16, placement=mesh, device="cuda"))


def test_coalesce_key_and_sell_key_fold_the_placement():
    keys = {ExecSpec(placement=p).coalesce_key() for p in
            (3, _mesh(3), ["cpu"] * 3, sell_shard.device_mesh(3, _mesh(3)))}
    assert len(keys) == 1
    assert next(iter(keys))[3] == 3
    assert ExecSpec(placement=_mesh(3)).coalesce_key() != \
        ExecSpec(placement=_mesh(2)).coalesce_key()
    assert ExecSpec().coalesce_key() == ExecSpec(placement=1).coalesce_key()
    assert ExecSpec(placement=["cpu", "cpu"]).placement == ("cpu", "cpu")
    hash(ExecSpec(placement=["cpu", "cpu"]))
    ref, port = _csr_pair()
    for n in (1, 4):
        got = TuneCache.sell_key("spmv", port, device="cpu", n_devices=n)
        assert got == RefTuneCache.sell_key("spmv", ref, device="cpu",
                                            n_devices=n)
        assert got.endswith("|dev4") == (n == 4)


@pytest.mark.parametrize("n_devices", [2, 3])
def test_registry_and_service_with_mesh_match_unsharded(n_devices):
    _, csr = _csr_pair(300, 6.0, seed=1, skew=1.5)
    _, g = _graph_pair("rmat", 256, 8, 3)
    rng = np.random.default_rng(0)
    xs = [rng.standard_normal(300) for _ in range(5)]
    results = {}
    for mesh in (None, _mesh(n_devices)):
        cache = TuneCache()
        reg = KernelRegistry(cache=cache, device="cpu" if mesh is None
                             else None, mesh=mesh)
        op = reg.register_matrix("a", csr)
        gop = reg.register_graph("g", g)
        svc = KernelService(reg, n_slots=8)
        r = [svc.submit("spmv", "a", x) for x in xs]
        b = [svc.submit("bfs", "g", None, source=s) for s in (0, 7, 9)]
        p = [svc.submit("pagerank", "g", None, damping=d, iters=10)
             for d in (0.85, 0.9)]
        p32 = [svc.submit("pagerank", "g", None, damping=d, iters=10,
                          dtype="float32") for d in (0.85, 0.9)]
        svc.drain()
        stats = dict(svc.stats)
        assert stats["served"] == 12 and stats["failed"] == 0
        assert stats["groups"] == 4     # float32 and float64 never coalesce
        if mesh is None:
            assert op.mode == gop.mode == "resident"
            assert stats["sharded_launches"] == 0
        else:
            assert op.mode == gop.mode == "sharded"
            assert op.sharded.n_shards == gop.sharded.n_shards == n_devices
            assert stats["sharded_launches"] == 4
            assert reg.n_devices == n_devices
            assert any(k.endswith(f"|dev{n_devices}") for k in cache._entries)
            assert op.plans["spmv"].kernel == "spmm_sell_sharded"
        results[mesh] = [[svc.poll(i) for i in ids] for ids in (r, b, p, p32)]
        assert all(t.dtype == torch.float32 for t in results[mesh][3])
    one, many = results[None], results[_mesh(n_devices)]
    for a, b in zip(one[0] + one[1], many[0] + many[1]):
        assert torch.equal(a, b)                      # SpMV and BFS
    for a, b in zip(one[2], many[2]):
        torch.testing.assert_close(a, b, rtol=TOL, atol=0)
    for a, b in zip(one[3], many[3]):
        _fp32_close(b, _np(a), "service fp32 sharded vs unsharded",
                    SHARD_FP32)


def test_service_refuses_a_rank_dtype_no_kernel_takes():
    _, g = _graph_pair("uniform", 90, 4, 2)
    reg = KernelRegistry(device="cpu")
    reg.register_graph("g", g)
    svc = KernelService(reg)
    with pytest.raises(LaunchPlanError, match="float16"):
        svc.submit("pagerank", "g", None, dtype="float16")
    assert svc.stats["preflight_rejected"] == 1


# ---------------------------------------------------------------------------
# Float32 PageRank against the reference's x64-off path
# ---------------------------------------------------------------------------


def _fp32_close(got: torch.Tensor, want, what: str,
                tol: float = FP32) -> None:
    assert got.dtype == torch.float32, what
    want = np.asarray(want)
    assert want.dtype == np.float32, what
    g = _np(got).reshape(got.shape[0], -1).astype(np.float64)
    w = want.reshape(want.shape[0], -1).astype(np.float64)
    bound = tol * np.abs(w).max(axis=0)
    assert (np.abs(g - w) <= bound).all(), what


@pytest.fixture(scope="module")
def fp32_reference(small_graph):
    ref, port = small_graph
    rmat_ref, rmat = _graph_pair("rmat", 64, 4, 3)
    with jax.enable_x64(False):
        want = {layout: ref_ops.pagerank(
            rmat_ref, damping=[0.85, 0.9], iters=[6, 3],
            spec=RefExecSpec(layout=layout, vl=16, interpret=True))
            for layout in ("ell", "sell")}
        want["sharded"] = ref_shard.pagerank_sell_sharded(
            RG.shard_graph_slabs(ref.transpose(), c=32, n_shards=3),
            ref.out_degree.astype(np.float32), mesh=None, iters=3)
    return rmat, port, {k: np.asarray(v) for k, v in want.items()}


@pytest.mark.parametrize("layout", ["ell", "sell"])
def test_float32_pagerank_matches_reference_x64_off(fp32_reference, layout):
    rmat, _, want = fp32_reference
    got = ops.pagerank(rmat, damping=[0.85, 0.9], iters=[6, 3],
                       spec=dataclasses.replace(CPU, layout=layout, vl=16),
                       dtype=torch.float32)
    _fp32_close(got, want[layout], f"ops.pagerank {layout}")
    if layout == "sell":
        placed = ExecSpec(layout="sell", vl=16, placement=_mesh(3))
        assert torch.equal(got, ops.pagerank(
            rmat, damping=[0.85, 0.9], iters=[6, 3], spec=placed,
            dtype=torch.float32))


def test_float32_pagerank_sharded_matches_reference(fp32_reference):
    _, port, want = fp32_reference
    sg = G.shard_graph_slabs(port.transpose(), c=32, n_shards=3)
    got = sell_shard.pagerank_sell_sharded(
        sg, port.out_degree, mesh=_mesh(3), iters=3, dtype=torch.float32)
    _fp32_close(got, want["sharded"], "pagerank_sell_sharded fp32")
    with pytest.raises(TypeError, match="float32 or float64"):
        sell_shard.pagerank_sell_sharded(sg, port.out_degree, mesh=_mesh(3),
                                         dtype=torch.float16)


# ---------------------------------------------------------------------------
# Plans and the tuner
# ---------------------------------------------------------------------------


def test_plan_spmm_sell_sharded_prices_and_refuses():
    _, port = _csr_pair(500, 8.0, seed=1, skew=1.5)
    slabs = F.csr_to_sell_slabs(port, c=32)
    sharded = F.shard_slabs(slabs, 4)
    meta = SlabMeta.from_slabs(slabs, check_bounds=True)
    shard = SlabMeta.from_sharded(sharded, check_bounds=True)
    assert shard.n_rows == sharded.rows_max
    assert shard.n_cols == sharded.window_cols
    assert shard.n_slices == sharded.slices_per_shard
    plan = plan_spmm_sell_sharded(meta, k=8, x_dtype="float64", n_devices=4,
                                  k_block=8, window_cols=sharded.window_cols,
                                  shard=shard).raise_if_invalid()
    assert plan.kernel == "spmm_sell_sharded"
    assert len(plan.blocks) == len(sharded.widths) + 1
    coll = plan.blocks[-1]
    assert coll.label == "collectives" and coll.smem_bytes == 0
    assert coll.grid == (4,)
    assert ("x_window", (sharded.window_cols, 8), "float64") in coll.operands
    assert ("y_rows", (125, 8), "float64") in coll.operands
    k1 = plan_spmm_sell_sharded(meta, k=1, n_devices=4,
                                window_cols=sharded.window_cols, shard=shard)
    assert k1.ok and k1.n_launches == len(sharded.widths) + 1
    bad = plan_spmm_sell_sharded(meta, n_devices=0, window_cols=10**6,
                                 shard=shard)
    assert any("n_devices must be >= 1" in v for v in bad.violations)
    assert any("window_cols 1000000 outside" in v for v in bad.violations)
    with pytest.raises(LaunchPlanError, match="window_cols 0"):
        plan_spmm_sell_sharded(meta, n_devices=2, window_cols=0,
                               shard=shard).raise_if_invalid()
    with pytest.raises(LaunchPlanError, match="out of bounds"):
        plan_spmm_sell_sharded(dataclasses.replace(meta, idx_max=500),
                               n_devices=2, window_cols=sharded.window_cols,
                               shard=shard).raise_if_invalid()


def test_graph_plans_admit_float32_and_sharded_meta():
    _, port = _graph_pair("rmat", 300, 16, 7)
    sg = G.shard_graph_slabs(port.transpose(), c=8, n_shards=3)
    meta = SlabMeta.from_sharded(sg, check_bounds=True)
    assert meta.kind == "graph" and meta.n_slices == sg.slices_per_shard
    assert meta.map_max == port.n_nodes
    for dtype in ("float32", "float64"):
        assert plan_pagerank_sell(meta, k=32, dtype=dtype).ok
        assert plan_pagerank_ell(SlabMeta.from_ell(port.adj, 300),
                                 dtype=dtype).ok
    assert plan_bfs_sell(meta, k=32).ok
    for dtype in ("float16", "int32"):
        with pytest.raises(LaunchPlanError, match="instantiations"):
            plan_pagerank_sell(meta, dtype=dtype).raise_if_invalid()
    # the split parts' partial sums are priced at the rank's itemsize
    w = max(meta.widths)
    s = meta.n_slices[meta.widths.index(w)]
    f64 = autotune.node_split(w, 8, s, 32, 8, "pagerank")
    f32 = autotune.node_split(w, 8, s, 32, 4, "pagerank")
    assert f64.parts > 1 and f32.parts > 1
    assert f32.smem_bytes == f32.nodes * f32.parts * 32 * 4
    assert f64.smem_bytes == f64.nodes * f64.parts * 32 * 8
    assert autotune.node_split(w, 8, s, 32, 4, "bfs").smem_bytes == \
        4 * f32.nodes


def test_tune_sell_layout_scores_the_busiest_shard():
    """With n_devices the tune scores the busiest shard's rows, under the
    reference's partition, exactly as a tune of those rows alone."""
    lengths = np.concatenate([np.full(300, 2), np.random.default_rng(1)
                              .integers(1, 120, 200)]).astype(np.int64)
    ranges = RF.shard_row_ranges(lengths, 4)
    lo, hi = max(ranges, key=lambda r: int(lengths[r[0]:r[1]].sum()))
    got = autotune.tune_sell_layout(lengths, n_devices=4)
    want = autotune.tune_sell_layout(lengths[lo:hi])
    assert (got.c, got.sigma, got.pad_factor) == \
        (want.c, want.sigma, want.pad_factor)
    assert got.table == want.table
    # the reference scores the same rows (its own cost model ranks them)
    ref_got = ref_autotune.tune_sell_layout(lengths, n_devices=4)
    ref_want = ref_autotune.tune_sell_layout(lengths[lo:hi])
    assert (ref_got.c, ref_got.sigma) == (ref_want.c, ref_want.sigma)
    whole = autotune.tune_sell_layout(lengths)
    assert whole.table != got.table
