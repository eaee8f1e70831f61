"""Kernel B1 (``csrc/spmm_sell.cu``), the streaming SpMM B2
(``csrc/spmm_sell_stream.cu``), the graph kernels B3, B4, B5
(``csrc/graph_step.cu``), the ELLPACK SpMV B6 (``csrc/spmv_ell.cu``) and
the FFT B7 (``csrc/fft_stockham.cu``), the fused SSD scan B8
(``csrc/ssd_fused.cu``) and the embedding gather B9
(``csrc/embedding_gather.cu``) against their plain PyTorch versions on the
card, the reduced mamba2, dense attention, hybrid, vision and enc-dec LM
paths on the card
against the CPU, and the sweep study's ``measure_cuda`` (B4, B5, B6, B7
through ``ops``).  Every test here carries the ``cuda`` marker and skips without
a GPU (decided inside the fixture, never at import).  This file imports
neither ``jax`` nor ``repro``, so it runs on a machine that has only the
port's dependencies:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: 1e-10 at fp64, 1e-4 x max|y| at fp32 (summation order differs);
B2 bit-equal to B1 wherever B1 walks each bucket with one thread a row
(the same multiply-adds in the same order), and within 1e-10 (fp64) of it
on buckets B1 splits across threads;
BFS distances exactly equal, PageRank ranks at rtol 1e-10 (B3's split
buckets add their parts in a fixed order: two calls bit-equal); FFT rtol 1e-9 /
atol 1e-9 x n at fp64 and 1e-3 / 1e-5 x max|spectrum| at fp32 (FMA
contraction); B6's k-column form bit-equal to its one-column launches; B8
2e-4 at fp32 and 1e-10 at fp64 (the reference's, ``tests/test_kernels.py``),
its backward the same, fp32 relative to max(1, max|grad|), two calls
bit-equal; B9 exactly equal (a copy), its backward and its shard form's
backward equal to their plain versions (the same sums in the same order)
and within 1e-6 x max of ``index_add_``; the reduced mamba2 train step's
loss 1e-5 relative and its gradients 1e-4 x max|g| against the CPU, and on
a mesh naming the card four times against the unsharded step on the card.
"""
import copy
import types

import numpy as np
import pytest
import torch

from repro_torch.kernels import ops, sell_core
from repro_torch.kernels.execspec import ExecSpec
from repro_torch.sparse import formats as F


@pytest.fixture
def cuda_device():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU; on the card run `python -m pytest "
                    "--noconftest -m cuda tests/test_torch_cuda.py`")
    return torch.device("cuda")


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10), (np.float32, 1e-4)])
def test_kernel_matches_plain_version(cuda_device, dtype, tol):
    csr = F.random_csr(3000, 2500, 9.0, seed=5, skew=1.2, dtype=dtype)
    rng = np.random.default_rng(0)
    for c in (8, 32, 256):
        cols, vals, rows = F.csr_to_sell_slabs(csr, c=c).to_device(cuda_device)
        for k, kb in ((1, 8), (5, 4), (32, 32)):
            x = torch.from_numpy(
                rng.standard_normal((2500, k)).astype(dtype)).to(cuda_device)
            before = sell_core.KERNEL_LAUNCHES
            got = sell_core.spmm_sell(cols, vals, rows, x, n_rows=3000,
                                      k_block=kb)
            torch.cuda.synchronize()
            assert sell_core.KERNEL_LAUNCHES == before + len(cols)
            want = sell_core.spmm_sell_ref(cols, vals, rows, x, n_rows=3000)
            scale = 1.0 if dtype == np.float64 else float(want.abs().max())
            assert float((got - want).abs().max()) <= tol * scale


def _wide_row_csr(dtype, n_rows=4000, n_cols=3500, wide=2000, seed=11):
    """Short random rows and one row of ``wide`` entries: its slice lands
    in a bucket of width 2048, which B1 splits across threads."""
    rng = np.random.default_rng(seed)
    lengths = rng.integers(1, 9, n_rows)
    lengths[n_rows // 3] = wide
    indptr = np.concatenate([[0], np.cumsum(lengths)])
    indices = np.concatenate([np.sort(rng.choice(n_cols, n, replace=False))
                              for n in lengths]).astype(np.int32)
    data = rng.standard_normal(indptr[-1]).astype(dtype)
    return F.CSRMatrix(indptr=indptr, indices=indices, data=data,
                       n_cols=n_cols)


def _assert_b2_matches_b1(got, b1, cols, dtype) -> None:
    """B2 bit-equal to B1 where B1 walks every bucket with one thread a
    row; where it splits one, the two sum those rows in different orders
    and agree at the tolerance (1e-10 fp64, 1e-4 x max|y| fp32)."""
    if not sell_core.splits(cols):
        assert torch.equal(got, b1)
        return
    scale = 1.0 if dtype == np.float64 else float(b1.abs().max())
    tol = 1e-10 if dtype == np.float64 else 1e-4
    assert float((got - b1).abs().max()) <= tol * scale


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10), (np.float32, 1e-4)])
@pytest.mark.parametrize("k", [1, 3, 8, 32])
def test_split_bucket_matches_plain_version_and_repeats(cuda_device, dtype,
                                                        tol, k):
    """A row of 2,000 entries among short ones: its W = 2048 bucket runs
    split across threads (the narrow buckets one thread a row).  The
    result matches the plain version and two calls give the same bits."""
    from repro_torch.core.autotune import spmm_split

    csr = _wide_row_csr(dtype)
    slabs = F.csr_to_sell_slabs(csr, c=32)
    assert slabs.bucket_cols[-1].shape[1] == 2048
    assert spmm_split(2048, 32, slabs.bucket_cols[-1].shape[0]).parts > 1
    narrow = slabs.bucket_cols[0]
    assert spmm_split(narrow.shape[1], 32, narrow.shape[0]).parts == 1
    cols, vals, rows = slabs.to_device(cuda_device)
    x = torch.from_numpy(np.random.default_rng(k).standard_normal(
        (csr.n_cols, k)).astype(dtype)).to(cuda_device)
    before = sell_core.KERNEL_LAUNCHES
    got = sell_core.spmm_sell(cols, vals, rows, x, n_rows=csr.n_rows,
                              k_block=32)
    again = sell_core.spmm_sell(cols, vals, rows, x, n_rows=csr.n_rows,
                                k_block=32)
    torch.cuda.synchronize()
    assert sell_core.KERNEL_LAUNCHES == before + 2 * len(cols)
    assert torch.equal(got, again)
    want = sell_core.spmm_sell_ref(cols, vals, rows, x, n_rows=csr.n_rows)
    scale = 1.0 if dtype == np.float64 else float(want.abs().max())
    assert float((got - want).abs().max()) <= tol * scale
    host = np.stack([csr.matvec(x[:, j].double().cpu().numpy())
                     for j in range(k)], axis=1)
    assert float(np.abs(got.double().cpu().numpy() - host).max()) \
        <= tol * (1.0 if dtype == np.float64 else float(np.abs(host).max()))


@pytest.mark.cuda
def test_ops_spmv_on_the_card_matches_host_csr(cuda_device):
    csr = F.cage10_like(seed=0)
    x = np.random.default_rng(1).standard_normal(csr.n_cols)
    y = ops.spmv(csr, x, spec=ExecSpec(vl=32))          # default device: cuda
    assert y.device.type == "cuda"
    np.testing.assert_allclose(y.cpu().numpy(), csr.matvec(x),
                               rtol=1e-10, atol=1e-10)


@pytest.mark.cuda
def test_short_x_is_refused_on_the_card_and_a_longer_one_served(cuda_device):
    """An X with fewer rows than n_cols never reaches B1, B2 or B6 (they
    would gather past its end): ``ops`` raises naming both numbers and
    launches nothing.  A longer X is served from its first n_cols rows."""
    from repro_torch.kernels import spmv

    csr = F.random_csr(3000, 2500, 9.0, seed=5, skew=1.2)
    ell = F.csr_to_ellpack(csr, c=256)
    rng = np.random.default_rng(6)
    short = torch.from_numpy(rng.standard_normal((2499, 4))).to(cuda_device)
    long_ = torch.from_numpy(rng.standard_normal((2600, 4))).to(cuda_device)
    calls = (
        lambda x: ops.spmv(csr, x[:, 0], spec=ExecSpec(vl=32)),
        lambda x: ops.spmm(csr, x, spec=ExecSpec(vl=32)),
        lambda x: ops.spmm(csr, x, spec=ExecSpec(vl=32, mode="stream")),
        lambda x: ops.spmv(ell, x[:, 0], spec=ExecSpec(vl=256)),
        lambda x: ops.moe_dispatch(csr, x, spec=ExecSpec(vl=32), top_k=256),
    )
    torch.cuda.synchronize()
    before = (sell_core.KERNEL_LAUNCHES, sell_core.STREAM_LAUNCHES,
              spmv.KERNEL_LAUNCHES)
    for call in calls:
        with pytest.raises(ValueError, match=r"X has 2499 rows.*n_cols=2500"):
            call(short)
    assert (sell_core.KERNEL_LAUNCHES, sell_core.STREAM_LAUNCHES,
            spmv.KERNEL_LAUNCHES) == before
    host = np.stack([csr.matvec(long_[:2500, j].cpu().numpy())
                     for j in range(4)], axis=1)
    for i, call in enumerate(calls):
        y = call(long_)
        want = host[:, 0] if y.ndim == 1 else host
        np.testing.assert_allclose(y.cpu().numpy(), want, rtol=1e-10,
                                   atol=1e-10, err_msg=f"call {i}")


# ---------------------------------------------------------------------------
# Streaming SpMM B2
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10), (np.float32, 1e-4)])
def test_stream_kernel_matches_plain_version_and_b1(cuda_device, dtype, tol):
    """B2 against its plain version (tolerance: fma vs separate multiply
    and add) and bit-equal to B1 where B1 splits no bucket (else at the
    tolerance), over tiles that split X into many column tiles, a non-pow2
    row_tile and k tiles 1 .. 32."""
    csr = F.random_csr(3000, 2500, 9.0, seed=5, skew=1.2, dtype=dtype)
    rng = np.random.default_rng(0)
    for c in (8, 32, 256):
        cols, vals, rows = F.csr_to_sell_slabs(csr, c=c).to_device(cuda_device)
        for k, kb, col_tile, row_tile in ((1, 8, 64, 3), (5, 4, None, None),
                                          (32, 32, 32, 5), (3, 2, 1 << 12, 1)):
            x = torch.from_numpy(
                rng.standard_normal((2500, k)).astype(dtype)).to(cuda_device)
            before = sell_core.STREAM_LAUNCHES
            got = sell_core.spmm_sell_stream(cols, vals, rows, x, n_rows=3000,
                                             k_block=kb, col_tile=col_tile,
                                             row_tile=row_tile)
            torch.cuda.synchronize()
            assert sell_core.STREAM_LAUNCHES == before + len(cols)
            b1 = sell_core.spmm_sell(cols, vals, rows, x, n_rows=3000,
                                     k_block=kb)
            _assert_b2_matches_b1(got, b1, cols, dtype)
            want = sell_core.spmm_sell_stream_ref(
                cols, vals, rows, x, n_rows=3000, col_tile=col_tile or 256)
            scale = 1.0 if dtype == np.float64 else float(want.abs().max())
            assert float((got - want).abs().max()) <= tol * scale


@pytest.mark.cuda
def test_stream_kernel_is_bit_equal_to_b1_on_unsorted_rows_and_inner_pad(
        cuda_device):
    """Rows in random column order, then the same rows with PAD before
    their entries: B2 reads the slabs B1 reads and stays bit-equal to it
    (within 1e-10 on the buckets B1 splits across threads); the plain B2
    (the TPU's tile-by-tile order) agrees at 1e-10."""
    import dataclasses

    csr = F.random_csr(3000, 2500, 9.0, seed=5, skew=1.2)
    rng = np.random.default_rng(4)
    indices, data = csr.indices.copy(), csr.data.copy()
    for lo, hi in zip(csr.indptr[:-1], csr.indptr[1:]):
        p = lo + rng.permutation(hi - lo)
        indices[lo:hi], data[lo:hi] = indices[p], data[p]
    shuffled = F.CSRMatrix(indptr=csr.indptr, indices=indices, data=data,
                           n_cols=csr.n_cols)
    slabs = F.csr_to_sell_slabs(shuffled, c=32)
    pad_first = dataclasses.replace(
        slabs,
        bucket_cols=tuple(np.roll(c, 1, axis=1) for c in slabs.bucket_cols),
        bucket_vals=tuple(np.roll(v, 1, axis=1) for v in slabs.bucket_vals))
    x = torch.from_numpy(rng.standard_normal((2500, 8))).to(cuda_device)
    for operand in (slabs, pad_first):
        cols, vals, rows = operand.to_device(cuda_device)
        got = sell_core.spmm_sell_stream(cols, vals, rows, x, n_rows=3000,
                                         k_block=8, col_tile=64, row_tile=3)
        _assert_b2_matches_b1(got, sell_core.spmm_sell(
            cols, vals, rows, x, n_rows=3000, k_block=8), cols, np.float64)
        want = sell_core.spmm_sell_stream_ref(cols, vals, rows, x,
                                              n_rows=3000, col_tile=64)
        assert float((got - want).abs().max()) <= 1e-10


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10), (np.float32, 1e-4)])
def test_stream_kernel_walks_many_chunks_a_block_with_a_given_map(
        cuda_device, dtype, tol):
    """Blocks whose column lists take many chunks (col_tile 16 and 64), on
    a banded and a rectangular operand, with the map built once and handed
    in: bit-equal to B1 where B1 splits no bucket, at the tolerance of the
    plain version, the same with and without the map."""
    for csr in (F.cage10_like(seed=0, dtype=dtype),
                F.random_csr(2048, 300_000, 6.0, seed=3, dtype=dtype)):
        cols, vals, rows = F.csr_to_sell_slabs(csr, c=32).to_device(
            cuda_device)
        rng = np.random.default_rng(1)
        for k, kb, col_tile in ((1, 1, 16), (8, 8, 64), (32, 32, 16)):
            x = torch.from_numpy(rng.standard_normal(
                (csr.n_cols, k)).astype(dtype)).to(cuda_device)
            _, rt = sell_core.pick_stream_tiles(32, min(kb, k))
            block_rows = sell_core.stream_bucket_rows(
                rt, [c.shape for c in cols])
            smap = F.stream_column_map(tuple(c.cpu().numpy() for c in cols),
                                       block_rows)
            assert max(smap.longest) > 2 * col_tile   # many chunks a block
            got = sell_core.spmm_sell_stream(
                cols, vals, rows, x, n_rows=csr.n_rows, k_block=kb,
                col_tile=col_tile, column_map=smap.to_device(cuda_device))
            again = sell_core.spmm_sell_stream(
                cols, vals, rows, x, n_rows=csr.n_rows, k_block=kb,
                col_tile=col_tile)
            torch.cuda.synchronize()
            assert torch.equal(got, again)
            _assert_b2_matches_b1(got, sell_core.spmm_sell(
                cols, vals, rows, x, n_rows=csr.n_rows, k_block=kb), cols,
                dtype)
            want = sell_core.spmm_sell_stream_ref(
                cols, vals, rows, x, n_rows=csr.n_rows, col_tile=col_tile)
            scale = 1.0 if dtype == np.float64 else float(want.abs().max())
            assert float((got - want).abs().max()) <= tol * scale


@pytest.mark.cuda
def test_stream_kernel_leaves_rows_no_bucket_names_at_zero(cuda_device):
    """Slabs adopted through slabs_from_arrays with one bucket left out:
    the rows that bucket held are named by no bucket and read 0 from B2,
    as from B1, even where the memory Y is carved from held NaN."""
    full = F.csr_to_sell_slabs(F.random_csr(3000, 2500, 9.0, seed=5,
                                            skew=1.2), c=32)
    keep = slice(1, None)
    sub = F.slabs_from_arrays(types.SimpleNamespace(
        bucket_cols=full.bucket_cols[keep], bucket_vals=full.bucket_vals[keep],
        bucket_rows=full.bucket_rows[keep], n_rows=full.n_rows,
        n_cols=full.n_cols, sigma=full.sigma,
        nnz=sum(int((c != F.PAD).sum()) for c in full.bucket_cols[keep])))
    unnamed = np.setdiff1d(np.arange(sub.n_rows), np.concatenate(
        [r.ravel() for r in sub.bucket_rows]))
    assert unnamed.size
    cols, vals, rows = sub.to_device(cuda_device)
    x = torch.from_numpy(np.random.default_rng(4).standard_normal(
        (2500, 8))).to(cuda_device)
    torch.full((sub.n_rows + 1, 8), float("nan"), dtype=torch.float64,
               device=cuda_device)            # freed to the caching allocator
    got = sell_core.spmm_sell_stream(cols, vals, rows, x, n_rows=sub.n_rows,
                                     k_block=8)
    b1 = sell_core.spmm_sell(cols, vals, rows, x, n_rows=sub.n_rows,
                             k_block=8)
    torch.cuda.synchronize()
    assert not got[torch.from_numpy(unnamed).to(cuda_device)].any()
    _assert_b2_matches_b1(got, b1, cols, np.float64)


@pytest.mark.cuda
def test_ops_stream_on_the_card_matches_host_csr(cuda_device):
    csr = F.cage10_like(seed=0)
    x = np.random.default_rng(2).standard_normal((csr.n_cols, 4))
    y = ops.spmm(csr, x, spec=ExecSpec(vl=32, mode="stream"))
    assert y.device.type == "cuda"
    want = np.stack([csr.matvec(x[:, j]) for j in range(4)], axis=1)
    np.testing.assert_allclose(y.cpu().numpy(), want, rtol=1e-10, atol=1e-10)


@pytest.mark.cuda
def test_refused_stream_launch_raises_and_leaves_no_error_behind(cuda_device):
    """Two X tiles a block cannot get: the wrapper raises instead of
    returning garbage, counts no launch, and the next launch runs clean."""
    from repro_torch.core import autotune

    csr = F.random_csr(500, 40_000, 4.0, seed=3)
    cols, vals, rows = F.csr_to_sell_slabs(csr, c=32).to_device(cuda_device)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (40_000, 1))).to(cuda_device)
    y = torch.zeros((501, 1), dtype=x.dtype, device=cuda_device)
    ct, rt = autotune.pick_stream_tiles(32, 1, 8)
    block_rows = sell_core.stream_bucket_rows(rt, [c.shape for c in cols])
    smap = F.stream_column_map(tuple(c.cpu().numpy() for c in cols),
                               block_rows).to_device(cuda_device)
    before = sell_core.STREAM_LAUNCHES
    with pytest.raises(RuntimeError, match="cudaError"):
        sell_core._launch_stream_bucket(
            smap.lcols[0], vals[0], rows[0], smap.lane_end[0],
            smap.block_ptr[0], smap.block_cols[0], x, y, 1, 2 * ct,
            block_rows[0], torch.cuda.current_stream().cuda_stream)
    assert sell_core.STREAM_LAUNCHES == before
    got = sell_core.spmm_sell_stream(cols, vals, rows, x, n_rows=500,
                                     k_block=1)
    torch.cuda.synchronize()
    assert sell_core.STREAM_LAUNCHES == before + len(cols)
    assert torch.equal(got, sell_core.spmm_sell(cols, vals, rows, x,
                                                n_rows=500, k_block=1))


# ---------------------------------------------------------------------------
# Graph kernels B3 (BFS and PageRank combines), B4 and B5
# ---------------------------------------------------------------------------


def _graph_case(G, n=2053):
    g = G.rmat_graph(n, 8, seed=7)
    return g, g.transpose()


@pytest.mark.cuda
@pytest.mark.parametrize("c", [8, 32, 256])
def test_graph_sell_kernels_match_plain_versions(cuda_device, c):
    """B3 with both combines against its plain version: BFS exactly,
    PageRank at rtol 1e-10 (only the summation order differs)."""
    from repro_torch.graphs import gen as G
    from repro_torch.kernels import bfs, pagerank

    g, rg = _graph_case(G)
    n = g.n_nodes
    adj, nodes = G.graph_to_sell_slabs(rg, c=c).to_device(cuda_device)
    rng = np.random.default_rng(c)
    for k in (None, 1, 6, 32):
        cols = 1 if k is None else k
        shape = (n + 1,) if k is None else (n + 1, k)
        dist = torch.full(shape, G.INF, dtype=torch.int32, device=cuda_device)
        src = torch.from_numpy(rng.choice(n, cols, replace=False))
        if k is None:
            dist[int(src[0])] = 0
        else:
            dist[src.to(cuda_device), torch.arange(k, device=cuda_device)] = 0
        for level in (1, 2, 3):
            before = bfs.KERNEL_LAUNCHES["bfs_step_sell"]
            got = bfs.bfs_step_sell(adj, nodes, dist, level)
            torch.cuda.synchronize()
            assert bfs.KERNEL_LAUNCHES["bfs_step_sell"] == before + len(adj)
            assert torch.equal(got, bfs.bfs_step_sell_ref(adj, nodes, dist,
                                                          level))
            dist = got
        contrib = torch.from_numpy(rng.random(shape)).to(cuda_device)
        contrib[-1] = 0.0
        consts = torch.from_numpy(
            rng.random((3,) if k is None else (3, k))).to(cuda_device)
        got = pagerank.pagerank_step_sell(adj, nodes, contrib, consts)
        want = pagerank.pagerank_step_sell_ref(adj, nodes, contrib, consts)
        torch.testing.assert_close(got, want, rtol=1e-10, atol=0)


@pytest.mark.cuda
@pytest.mark.parametrize("c", [8, 32])
def test_graph_sell_split_buckets_match_plain_versions(cuda_device, c):
    """B3's split buckets (rmat's widest in-degree slices, 16 .. 1,024
    threads a node) at k in (1, 3, 8, 32): BFS exactly equal to the plain
    step over four levels, PageRank at rtol 1e-10; two calls bit-equal
    (the parts add in a fixed order)."""
    from repro_torch.core import autotune
    from repro_torch.graphs import gen as G
    from repro_torch.kernels import bfs, pagerank

    g = G.rmat_graph(4096, 16, seed=1)
    n = g.n_nodes
    adj, nodes = G.graph_to_sell_slabs(g.transpose(), c=c).to_device(
        cuda_device)
    rng = np.random.default_rng(c)
    for k in (1, 3, 8, 32):
        kt = sell_core.node_k_tile(k)
        for itemsize in (4, 8):
            assert any(autotune.node_split(
                a.shape[2], c, a.shape[0], kt, itemsize,
                "bfs" if itemsize == 4 else "pagerank").parts > 1
                for a in adj)
        dist = torch.full((n + 1, k), G.INF, dtype=torch.int32,
                          device=cuda_device)
        src = torch.from_numpy(rng.choice(n, k, replace=False))
        dist[src.to(cuda_device), torch.arange(k, device=cuda_device)] = 0
        for level in range(1, 5):
            got = bfs.bfs_step_sell(adj, nodes, dist, level)
            torch.cuda.synchronize()
            assert torch.equal(got, bfs.bfs_step_sell_ref(adj, nodes, dist,
                                                          level))
            dist = got
        contrib = torch.from_numpy(rng.random((n + 1, k))).to(cuda_device)
        contrib[-1] = 0.0
        consts = torch.from_numpy(rng.random((3, k))).to(cuda_device)
        got = pagerank.pagerank_step_sell(adj, nodes, contrib, consts)
        assert torch.equal(got, pagerank.pagerank_step_sell(
            adj, nodes, contrib, consts))
        torch.testing.assert_close(got, pagerank.pagerank_step_sell_ref(
            adj, nodes, contrib, consts), rtol=1e-10, atol=0)


@pytest.mark.cuda
def test_graph_ell_kernels_and_ops_match_host_references(cuda_device):
    """B4 (its frontier pass and walk) / B5 against their plain versions,
    and ``ops.bfs`` / ``ops.pagerank`` on both layouts against the host
    references."""
    from repro_torch.graphs import gen as G
    from repro_torch.kernels import bfs, pagerank

    g, rg = _graph_case(G, n=4093)
    radj = rg.to_device(cuda_device)
    deg = torch.from_numpy(g.out_degree.astype(np.float64)).to(cuda_device)
    before = dict(bfs.KERNEL_LAUNCHES)
    dist = bfs.bfs(radj, 11)
    levels = int(dist[dist != G.INF].max()) + 1
    for key in ("bfs_step", "bfs_frontier"):
        assert bfs.KERNEL_LAUNCHES[key] == before[key] + levels
    assert torch.equal(dist, bfs.bfs_ref(radj, 11))
    np.testing.assert_array_equal(dist.cpu().numpy(), G.bfs_reference(g, 11))
    # B4 level by level, from several sources, on this adjacency and on a
    # holey one (PAD inside rows, the warp of nodes 32 .. 63 all PAD); B5
    # twice on each, bit-equal, and at rtol 1e-10 of its plain version
    holey = rg.adj.copy()
    holey[np.random.default_rng(3).random(holey.shape) < 0.25] = G.PAD
    holey[32:64] = G.PAD
    for adj in (radj, G.EllpackGraph(adj=holey, n_nodes=4093)
                .to_device(cuda_device)):
        live = bfs.ell_live_widths(adj)
        for src in (0, 11, 2000, 4092):
            d = torch.full((4093,), G.INF, dtype=torch.int32,
                           device=cuda_device)
            d[src] = 0
            for level in range(1, 64):
                front = bfs.bfs_frontier(d, level)
                assert torch.equal(front, bfs.bfs_frontier_ref(d, level))
                got = bfs.bfs_step(adj, d, level, live_width=live)
                assert torch.equal(got, bfs.bfs_step_ref(adj, d, level))
                assert torch.equal(got, bfs.bfs_step(adj, d, level))
                if torch.equal(got, d):
                    break
                d = got
        contrib = torch.from_numpy(np.random.default_rng(4).random(4093)).to(
            cuda_device)
        consts = torch.tensor([0.15 / 4093, 0.85, 1e-5], dtype=torch.float64,
                              device=cuda_device)
        got = pagerank.pagerank_step(adj, contrib, consts, live_width=live)
        assert torch.equal(got, pagerank.pagerank_step(adj, contrib, consts))
        torch.testing.assert_close(got, pagerank.pagerank_step_ref(
            adj, contrib, consts), rtol=1e-10, atol=0)
    rank = pagerank.pagerank(radj, deg, damping=0.9, iters=7)
    torch.testing.assert_close(rank, pagerank.pagerank_ref(
        radj, deg, damping=0.9, iters=7), rtol=1e-10, atol=0)
    for layout in ("ell", "sell"):
        spec = ExecSpec(layout=layout, vl=32)
        d = ops.bfs(g, [11, 400], spec=spec)
        assert d.device.type == "cuda"
        np.testing.assert_array_equal(d[:, 1].cpu().numpy(),
                                      G.bfs_reference(g, 400))
        r = ops.pagerank(g, damping=[0.85, 0.9], iters=[20, 7], spec=spec)
        np.testing.assert_allclose(r[:, 1].cpu().numpy(),
                                   G.pagerank_reference(g, 0.9, 7),
                                   rtol=1e-10, atol=0)


# ---------------------------------------------------------------------------
# Float32 PageRank (B3's PageRank forms and B5 in float) and the sharded
# drives on one card
# ---------------------------------------------------------------------------

#: blake2b digests of the float64 PageRank kernels' outputs on the inputs
#: of :func:`pagerank_fp64_cases`, read from the kernels before they were
#: templated on the rank type (``scripts/graph_fp_turns.py`` on an NVIDIA
#: H100 80GB HBM3): the float64 forms must stay bit-equal to them.
PAGERANK_FP64_DIGESTS = {
    "B3 rmat4096 k=None": "d94db1a4a926c227dc6b67852bdaa851",
    "B3 rmat4096 k=1": "ce02dae249de92770f3349e577b26942",
    "B3 rmat4096 k=3": "a210a97b7eef42571e162988b38f8514",
    "B3 rmat4096 k=32": "ad5e50e4653c182027472d98ebc3a8f8",
    "B5 rmat4096": "07c9b16753d3789637ba4b173b1fb7ec",
    "B3 uniform4093 k=None": "135c39733427d828b140305796006342",
    "B3 uniform4093 k=1": "79003e5d21d2c542f1565c481ec8b25c",
    "B3 uniform4093 k=3": "d74671ab0638b8532cd2ec9c7a8666bb",
    "B3 uniform4093 k=32": "3cabbc79085e842db8d8d639616c3e3b",
    "B5 uniform4093": "02e18e149811fa402dff97d1f9606304",
}


def _digest(t: torch.Tensor) -> str:
    import hashlib

    return hashlib.blake2b(t.cpu().numpy().tobytes(),
                           digest_size=16).hexdigest()


def pagerank_fp64_cases(G, step_sell, step_ell, device) -> dict:
    """The float64 PageRank steps of B3 (unsplit and split buckets, k =
    1 / 3 / 32 and one configuration) and B5 on fixed inputs: name ->
    output.  ``step_sell(adj, nodes, contrib, consts)`` and ``step_ell(radj,
    contrib, consts)`` are the launches under test."""
    from repro_torch.kernels import bfs

    rng = np.random.default_rng(27)
    out = {}
    for name, g, c in (("rmat4096", G.rmat_graph(4096, 16, seed=1), 8),
                       ("uniform4093", G.random_graph(4093, 8, seed=2), 32)):
        n = g.n_nodes
        adj, nodes = G.graph_to_sell_slabs(g.transpose(), c=c).to_device(device)
        for k in (None, 1, 3, 32):
            shape = (n + 1,) if k is None else (n + 1, k)
            contrib = torch.from_numpy(rng.random(shape)).to(device)
            contrib[-1] = 0.0
            consts = torch.from_numpy(
                rng.random((3,) if k is None else (3, k))).to(device)
            out[f"B3 {name} k={k}"] = step_sell(adj, nodes, contrib, consts)
        radj = g.transpose().to_device(device)
        contrib = torch.from_numpy(rng.random(n)).to(device)
        consts = torch.from_numpy(rng.random(3)).to(device)
        out[f"B5 {name}"] = step_ell(radj, bfs.ell_live_widths(radj), contrib,
                                     consts)
    torch.cuda.synchronize()
    return out


@pytest.mark.cuda
def test_pagerank_fp64_forms_bit_equal_to_before(cuda_device):
    from repro_torch.graphs import gen as G
    from repro_torch.kernels import pagerank

    got = pagerank_fp64_cases(
        G, pagerank.pagerank_step_sell,
        lambda radj, live, contrib, consts: pagerank.pagerank_step(
            radj, contrib, consts, live_width=live), cuda_device)
    assert {name: _digest(t) for name, t in got.items()} == \
        PAGERANK_FP64_DIGESTS


def _fp32_close(got, want, what: str) -> None:
    """Float32 ranks against their plain version: 1e-4 x max|rank| a
    column (the port's fp32 scale; only the summation order differs)."""
    assert got.dtype == want.dtype == torch.float32 and got.shape == want.shape
    g = got.reshape(got.shape[0], -1).double()
    w = want.reshape(want.shape[0], -1).double()
    bound = 1e-4 * w.abs().amax(dim=0)
    assert bool(((g - w).abs() <= bound).all()), what


@pytest.mark.cuda
@pytest.mark.parametrize("c", [8, 32])
def test_graph_fp32_pagerank_forms_match_plain_versions(cuda_device, c):
    """B3's float PageRank forms on unsplit and split buckets (rmat's
    widest in-degree slices) at k in (scalar, 1, 3, 32) and B5's float
    form, against their plain versions at 1e-4 x max|rank| a column; two
    calls bit-equal; ``ops.pagerank(dtype=torch.float32)`` on both layouts
    against the plain drives."""
    from repro_torch.core import autotune
    from repro_torch.graphs import gen as G
    from repro_torch.kernels import bfs, pagerank

    rng = np.random.default_rng(c)
    g = G.rmat_graph(4096, 16, seed=1)
    n = g.n_nodes
    adj, nodes = G.graph_to_sell_slabs(g.transpose(), c=c).to_device(
        cuda_device)
    for k in (None, 1, 3, 32):
        kt = sell_core.node_k_tile(1 if k is None else k)
        assert any(autotune.node_split(a.shape[2], c, a.shape[0], kt, 4,
                                       "pagerank").parts > 1 for a in adj)
        assert any(autotune.node_split(a.shape[2], c, a.shape[0], kt, 4,
                                       "pagerank").parts == 1 for a in adj)
        shape = (n + 1,) if k is None else (n + 1, k)
        contrib = torch.from_numpy(rng.random(shape).astype(np.float32)).to(
            cuda_device)
        contrib[-1] = 0.0
        consts = torch.from_numpy(rng.random(
            (3,) if k is None else (3, k)).astype(np.float32)).to(cuda_device)
        before = dict(pagerank.KERNEL_LAUNCHES)
        got = pagerank.pagerank_step_sell(adj, nodes, contrib, consts)
        torch.cuda.synchronize()
        assert pagerank.KERNEL_LAUNCHES["pagerank_step_sell_fp32"] == \
            before["pagerank_step_sell_fp32"] + len(adj)
        assert pagerank.KERNEL_LAUNCHES["pagerank_step_sell"] == \
            before["pagerank_step_sell"]
        assert torch.equal(got, pagerank.pagerank_step_sell(
            adj, nodes, contrib, consts))
        _fp32_close(got, pagerank.pagerank_step_sell_ref(
            adj, nodes, contrib, consts), f"B3 fp32 C={c} k={k}")
    radj = g.transpose().to_device(cuda_device)
    live = bfs.ell_live_widths(radj)
    contrib = torch.from_numpy(rng.random(n).astype(np.float32)).to(
        cuda_device)
    consts = torch.tensor([0.15 / n, 0.85, 1e-5], dtype=torch.float32,
                          device=cuda_device)
    got = pagerank.pagerank_step(radj, contrib, consts, live_width=live)
    assert torch.equal(got, pagerank.pagerank_step(radj, contrib, consts))
    _fp32_close(got, pagerank.pagerank_step_ref(radj, contrib, consts),
                "B5 fp32")
    deg = torch.from_numpy(g.out_degree.astype(np.float64)).to(cuda_device)
    for layout in ("ell", "sell"):
        r = ops.pagerank(g, damping=[0.85, 0.9], iters=[20, 7],
                         spec=ExecSpec(layout=layout, vl=c,
                                       device=cuda_device.type),
                         dtype=torch.float32)
        if layout == "sell":
            want = pagerank.pagerank_sell_ref(
                adj, nodes, deg, n, damping=[0.85, 0.9], iters=[20, 7],
                dtype=torch.float32)
        else:
            want = torch.stack([pagerank.pagerank_ref(
                radj, deg, damping=d, iters=it, dtype=torch.float32)
                for d, it in ((0.85, 20), (0.9, 7))], dim=1)
        _fp32_close(r, want, f"ops.pagerank fp32 {layout}")


@pytest.mark.cuda
def test_sharded_drives_on_one_card_bit_equal_to_unsharded(cuda_device):
    """The four sharded drives on a mesh naming the card three times:
    each ``torch.equal`` to the serial fold (the same per-shard launches)
    and, on operands none of whose buckets B1 or B3 splits, to the
    unsharded port; RHS-sharded SpMM and BFS equal everywhere; the same
    through ``ops`` and through a registry with the mesh and the
    service."""
    from repro_torch.core import autotune
    from repro_torch.graphs import gen as G
    from repro_torch.kernels import bfs, pagerank, sell_shard
    from repro_torch.service import KernelRegistry, KernelService

    mesh = (cuda_device,) * 3
    rng = np.random.default_rng(9)
    csr = F.random_csr(6000, 6000, 9.0, seed=5, skew=0.3)
    slabs = F.csr_to_sell_slabs(csr, c=32)
    assert not sell_core.splits(slabs.bucket_cols)
    sharded = F.shard_slabs(slabs, 3)
    assert not sell_core.splits(tuple(b[0] for b in sharded.bucket_cols))
    cols, vals, rows = slabs.to_device(cuda_device)
    for k in (1, 8, 32):
        x = torch.from_numpy(rng.standard_normal((6000, k))).to(cuda_device)
        want = sell_core.spmm_sell(cols, vals, rows, x, n_rows=6000,
                                   k_block=8)
        got = sell_shard.spmm_sell_sharded(sharded, x, mesh=mesh, k_block=8)
        assert torch.equal(got, sell_shard.spmm_sell_sharded(sharded, x,
                                                             k_block=8))
        assert torch.equal(got, want)
        assert torch.equal(sell_shard.spmm_sell_rhs_sharded(
            slabs, x, mesh=mesh, k_block=8), want)
        assert torch.equal(ops.spmm(slabs, x, spec=ExecSpec(
            vl=32, k_block=8, placement=mesh)), want)
    g = G.random_graph(5000, 8, seed=4)
    n = g.n_nodes
    rg = g.transpose()
    sg = G.shard_graph_slabs(rg, c=32, n_shards=3)
    assert max(sg.widths) < autotune.NODE_SPLIT_WIDTH
    adj, nodes = G.graph_to_sell_slabs(rg, c=32).to_device(cuda_device)
    deg = torch.from_numpy(g.out_degree.astype(np.float64)).to(cuda_device)
    src = [0, 17, 4999]
    d0 = bfs.bfs_sell(adj, nodes, n, src)
    assert torch.equal(sell_shard.bfs_sell_sharded(sg, src, mesh=mesh), d0)
    assert torch.equal(sell_shard.bfs_sell_sharded(sg, src,
                                                   device=cuda_device), d0)
    for dtype in (torch.float64, torch.float32):
        r0 = pagerank.pagerank_sell(adj, nodes, deg, n, damping=[0.85, 0.9],
                                    iters=12, dtype=dtype)
        r1 = sell_shard.pagerank_sell_sharded(
            sg, deg, mesh=mesh, damping=[0.85, 0.9], iters=12, dtype=dtype)
        assert torch.equal(r1, sell_shard.pagerank_sell_sharded(
            sg, deg, damping=[0.85, 0.9], iters=12, dtype=dtype,
            device=cuda_device))
        assert torch.equal(r1, r0)
    spec = ExecSpec(layout="sell", vl=32, placement=mesh)
    assert torch.equal(ops.bfs(g, src, spec=spec), d0)
    assert torch.equal(ops.pagerank(g, iters=12, spec=spec),
                       ops.pagerank(g, iters=12, spec=ExecSpec(
                           layout="sell", vl=32, device=cuda_device.type)))
    reg = KernelRegistry(mesh=mesh)
    reg.register_matrix("a", csr)
    reg.register_graph("g", g)
    svc = KernelService(reg, n_slots=8)
    xs = [rng.standard_normal(6000) for _ in range(4)]
    r = [svc.submit("spmv", "a", x) for x in xs]
    b = [svc.submit("bfs", "g", None, source=s) for s in src]
    svc.drain()
    assert svc.stats["sharded_launches"] == 2
    op = reg.get("a")
    want = sell_core.spmm_sell(*op.slabs.to_device(cuda_device),
                               torch.from_numpy(np.stack(xs, 1)).to(
                                   cuda_device), n_rows=6000,
                               k_block=op.tuned.k_block)
    for i, rid in enumerate(r):
        assert torch.equal(svc.poll(rid), want[:, i])
    for i, rid in enumerate(b):
        assert torch.equal(svc.poll(rid), d0[:, i])


# ---------------------------------------------------------------------------
# ELLPACK SpMV B6 and FFT B7
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10), (np.float32, 1e-4)])
def test_spmv_ell_kernel_matches_plain_version(cuda_device, dtype, tol):
    from repro_torch.kernels import spmv

    csr = F.random_csr(4093, 3000, 9.0, seed=6, skew=1.2, dtype=dtype)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(3000)
                         .astype(dtype)).to(cuda_device)
    for c in (8, 32, 256):
        cols, vals = F.csr_to_ellpack(csr, c=c).to_device(cuda_device)
        before = spmv.KERNEL_LAUNCHES
        got = spmv.spmv_ell(cols, vals, x)
        torch.cuda.synchronize()
        assert spmv.KERNEL_LAUNCHES == before + 1
        want = spmv.spmv_ell_ref(cols, vals, x)
        scale = 1.0 if dtype == np.float64 else float(want.abs().max())
        assert float((got - want).abs().max()) <= tol * scale
    ell = F.csr_to_ellpack(csr, c=256)
    y = ops.spmv(ell, x.cpu().numpy(), spec=ExecSpec())   # default vl 256: B6
    assert y.device.type == "cuda"
    want = ell.matvec(x.cpu().numpy())
    np.testing.assert_allclose(y.cpu().numpy(), want, rtol=0,
                               atol=tol * (1.0 if dtype == np.float64
                                           else float(np.abs(want).max())))


def _holey_ellpack(csr, c, seed):
    """``csr`` packed at height ``c`` with PAD punched inside rows and the
    rows 32 .. 63 (one warp) all PAD."""
    ell = F.csr_to_ellpack(csr, c=c)
    rng = np.random.default_rng(seed)
    cols, vals = ell.cols.copy(), ell.vals.copy()
    holes = rng.random(cols.shape) < 0.25
    cols[holes], vals[holes] = F.PAD, 0
    rows = cols.transpose(0, 2, 1).reshape(-1, cols.shape[1])
    rows[32:64] = F.PAD
    cols = np.ascontiguousarray(rows.reshape(cols.shape[0], cols.shape[2],
                                             cols.shape[1]).transpose(0, 2, 1))
    vals = np.where(cols == F.PAD, 0, vals).astype(vals.dtype)
    return F.EllpackMatrix(cols=cols, vals=vals, n_rows=ell.n_rows,
                           n_cols=ell.n_cols, nnz=int((cols != F.PAD).sum()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-10), (np.float32, 1e-4)])
def test_spmm_ell_k_form_is_bit_equal_to_column_by_column_b6(cuda_device,
                                                              dtype, tol):
    """B6's k-column form against k one-column launches (torch.equal: the
    same multiply-adds in the same order) and the plain version, with PAD
    inside rows and a whole warp of PAD; one launch a k tile; the live
    widths on the card against a host count."""
    from repro_torch.kernels import spmv

    csr = F.random_csr(3001, 2500, 11.0, seed=4, skew=1.3, dtype=dtype)
    for c in (8, 32, 256):
        ell = _holey_ellpack(csr, c, c)
        cols, vals = ell.to_device(cuda_device)
        live = spmv.live_widths(cols)
        rows = np.where(ell.cols != F.PAD, np.arange(1, ell.width + 1)[None, :, None],
                        0).max(axis=1).reshape(-1)
        rows = np.pad(rows, (0, -len(rows) % 32)).reshape(-1, 32).max(axis=1)
        np.testing.assert_array_equal(live.cpu().numpy(), rows)
        assert rows[1] == 0                      # the all-PAD warp
        for k in (1, 2, 3, 8, 32, 33):
            X = torch.from_numpy(np.random.default_rng(k).standard_normal(
                (2500, k)).astype(dtype)).to(cuda_device)
            before = spmv.KERNEL_LAUNCHES
            got = spmv.spmm_ell(cols, vals, X, live_width=live)
            torch.cuda.synchronize()
            assert spmv.KERNEL_LAUNCHES - before == (2 if k == 33 else 1)
            cbc = torch.stack([spmv.spmv_ell(cols, vals, X[:, i].contiguous(),
                                             live_width=live)
                               for i in range(k)], dim=1)
            assert torch.equal(got, cbc), (c, k)
            want = spmv.spmm_ell_ref(cols, vals, X)
            scale = 1.0 if dtype == np.float64 else float(want.abs().max())
            assert float((got - want).abs().max()) <= tol * scale


def _fft_case(n, batch, dtype, device, seed=0):
    from repro_torch.kernels import fft

    rng = np.random.default_rng(seed)
    re, im = (torch.from_numpy(rng.standard_normal((batch, n)).astype(dtype))
              .to(device) for _ in range(2))
    wre, wim = (torch.from_numpy(w).to(device)
                for w in fft.fft_twiddles(n, dtype))
    return re, im, wre, wim


def _fft_atol(dtype, n, want) -> float:
    """B7's absolute tolerance: 1e-9 x n at fp64; 1e-5 x the spectrum's
    largest component at fp32 (its error grows with the spectrum)."""
    if dtype == np.float64:
        return 1e-9 * n
    return 1e-5 * max(float(np.abs(np.asarray(w)).max()) for w in want)


@pytest.mark.cuda
@pytest.mark.parametrize("n,form", [(2048, "block"), (8192, "two_pass"),
                                    (1 << 17, "two_pass")])
@pytest.mark.parametrize("dtype,tol", [(np.float64, 1e-9), (np.float32, 1e-3)])
def test_fft_kernel_matches_plain_version(cuda_device, n, form, dtype, tol):
    """B7 in its in-block form (n = 2048) and in its two-pass form (n =
    8192 in fp64, where one signal's buffers exceed a block's shared
    memory, fp32 still fitting; n = 2^17 in both): two launches a call."""
    from repro_torch.kernels import fft

    args = _fft_case(n, 13, dtype, cuda_device)
    two_pass = form == "two_pass" and (dtype == np.float64 or n > 8192)
    key = "fft_stockham_two_pass" if two_pass else "fft_stockham_block"
    before = dict(fft.KERNEL_LAUNCHES)
    got = fft.fft_stockham(*args, b_block=8)
    torch.cuda.synchronize()
    grew = {k: fft.KERNEL_LAUNCHES[k] - before[k] for k in before}
    assert grew[key] == (2 if two_pass else 1)
    assert sum(grew.values()) == grew[key]
    want = fft.fft_stockham_ref(*args)
    atol = _fft_atol(dtype, n, [w.cpu() for w in want])
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=tol, atol=atol)
    spec = np.fft.fft(args[0].double().cpu().numpy()
                      + 1j * args[1].double().cpu().numpy())
    atol = _fft_atol(dtype, n, (spec.real, spec.imag))
    np.testing.assert_allclose(got[0].double().cpu().numpy(), spec.real,
                               rtol=tol, atol=atol)
    np.testing.assert_allclose(got[1].double().cpu().numpy(), spec.imag,
                               rtol=tol, atol=atol)
    # b_block groups signals; it never changes the result
    again = fft.fft_stockham(*args, b_block=1)
    for g, a in zip(got, again):
        assert torch.equal(g, a)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_fft_two_pass_tiles_do_not_change_the_result(cuda_device, dtype):
    """Each pass's tile only groups sub-signals into blocks: every tile
    from 1 up to the tuner's gives the same bits, at a length where the
    split is square (2^14) and where it is not (2^15)."""
    from repro_torch.core import autotune
    from repro_torch.kernels import fft

    for n in (1 << 14, 1 << 15):
        re, im, wre, wim = _fft_case(n, 5, dtype, cuda_device, seed=n)
        n1, _, tile_a, tile_b = autotune.fft_two_pass(n, re.element_size())
        results = []
        for ta, tb in ((1, 1), (2, 4), (tile_a, tile_b)):
            scratch = (torch.empty_like(re), torch.empty_like(im))
            out = (torch.empty_like(re), torch.empty_like(im))
            fft._launch_pass(True, re, im, wre, wim, *scratch, n1, ta)
            fft._launch_pass(False, *scratch, wre, wim, *out, n1, tb)
            results.append(out)
        torch.cuda.synchronize()
        for out in results[1:]:
            assert all(torch.equal(a, b) for a, b in zip(out, results[0]))
        tol = 1e-9 if dtype == np.float64 else 1e-3
        want = fft.fft_stockham_ref(re, im, wre, wim)
        atol = _fft_atol(dtype, n, [w.cpu() for w in want])
        for g, w in zip(results[0], want):
            torch.testing.assert_close(g, w, rtol=tol, atol=atol)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n", [2, 8, 64, 512, 2048, 4096, 8192])
def test_fft_in_block_form_matches_plain_version(cuda_device, n, dtype):
    """The in-block form at every length of the compare phase up to its
    limit (4096 fp64, 8192 fp32), with ragged last blocks (batches 1, 3,
    13 against the tuner's signals a block)."""
    from repro_torch.core import autotune
    from repro_torch.kernels import fft

    itemsize = np.dtype(dtype).itemsize
    if n > autotune.fft_block_limit(itemsize):
        pytest.skip(f"n = {n} runs the two-pass form in {np.dtype(dtype).name}")
    tol = 1e-9 if dtype == np.float64 else 1e-3
    for batch in (1, 3, 13):
        args = _fft_case(n, batch, dtype, cuda_device, seed=n + batch)
        want = fft.fft_stockham_ref(*args)
        atol = _fft_atol(dtype, n, [w.cpu() for w in want])
        before = dict(fft.KERNEL_LAUNCHES)
        got = fft.fft_stockham(*args, b_block=8)
        torch.cuda.synchronize()
        assert fft.KERNEL_LAUNCHES["fft_stockham_block"] == \
            before["fft_stockham_block"] + 1
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=tol, atol=atol)


@pytest.mark.cuda
def test_refused_fft_launch_raises_and_leaves_no_error_behind(cuda_device):
    """A block the card cannot take (too many signals: more threads than
    the kernel's launch bound, more shared memory than a block may claim)
    is refused: the wrapper raises instead of returning garbage, counts no
    launch, and the next launch runs clean."""
    from repro_torch.core import autotune
    from repro_torch.kernels import fft

    n = 2048
    re, im, wre, wim = _fft_case(n, 16, np.float64, cuda_device)
    signals = 1
    while autotune.fft_block_smem_bytes(n, signals, 8) <= autotune.SMEM_PER_BLOCK:
        signals += 1                                       # one too many
    out_re, out_im = torch.empty_like(re), torch.empty_like(im)
    before = dict(fft.KERNEL_LAUNCHES)
    with pytest.raises(RuntimeError, match="cudaError"):
        fft._launch_block(re, im, wre, wim, out_re, out_im, signals)
    assert fft.KERNEL_LAUNCHES == before
    got = ops.fft(re, im)                                  # default: the card
    torch.cuda.synchronize()
    for g, w in zip(got, fft.fft_stockham_ref(re, im, wre, wim)):
        torch.testing.assert_close(g, w, rtol=1e-9, atol=1e-9 * n)


# ---------------------------------------------------------------------------
# LM kernels: the embedding gather B9 and the fused SSD scan B8
# ---------------------------------------------------------------------------


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("d", [2560, 66, 3])
def test_gather_kernel_equals_plain_version(cuda_device, dtype, d):
    """B9 against ``table[ids]``, exactly (a gather is a copy): 16-byte
    vector copies (d = 2560), 8-byte (66 fp32) and 4-byte (3 fp32), also
    from a table that starts one row in (an unaligned base)."""
    from repro_torch.kernels import gather

    rng = np.random.default_rng(d)
    table = torch.from_numpy(rng.standard_normal((1000, d)).astype(dtype)) \
        .to(cuda_device)
    for tab in (table, table[1:]):
        for t in (1, 7, 512):
            ids = rng.integers(0, tab.shape[0], t)
            before = gather.KERNEL_LAUNCHES
            got = gather.embedding_gather(tab, ids)
            torch.cuda.synchronize()
            assert gather.KERNEL_LAUNCHES == before + 1
            assert torch.equal(got, gather.embedding_gather_ref(tab, ids))
    dev_ids = torch.tensor([999, 0, 5], device=cuda_device)   # on the card: unscanned
    assert torch.equal(gather.embedding_gather(table, dev_ids), table[dev_ids])


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2560, 3])
@pytest.mark.parametrize("id_dtype", [torch.int64, torch.int32])
def test_gather_device_ids_launch_once_without_a_conversion(cuda_device,
                                                           id_dtype, d,
                                                           monkeypatch):
    """Ids already on the card, int64 (the engine's argmax) or int32, at
    T = 1 and 512 and at an odd fp32 width (d = 3: the 4 B path): one launch
    a call, handed the caller's own id tensor (no conversion kernel, no
    copy), and the rows of ``table[ids]`` exactly."""
    from repro_torch.kernels import gather

    seen = []
    launch = gather._launch

    def spy(table, ids, out, chunks, threads, window=None):
        seen.append((ids.data_ptr(), ids.dtype))
        launch(table, ids, out, chunks, threads, window)

    monkeypatch.setattr(gather, "_launch", spy)
    table = torch.randn((5000, d), dtype=torch.float32, device=cuda_device)
    for t in (1, 512):
        ids = torch.randint(0, 5000, (t,), dtype=id_dtype, device=cuda_device)
        before = gather.KERNEL_LAUNCHES
        got = gather.embedding_gather(table, ids)
        torch.cuda.synchronize()
        assert gather.KERNEL_LAUNCHES == before + 1
        assert seen[-1] == (ids.data_ptr(), id_dtype)
        assert torch.equal(got, table[ids])


@pytest.mark.cuda
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
def test_gather_card_ids_out_of_range_read_inside_the_table(cuda_device,
                                                            id_dtype):
    """Ids on the card outside ``[0, V)`` (V, V + 7, -1, -V - 3, 2^31 - 1,
    and 2^31 for int64): the kernel bounds each by ``clamp_ids``'s rule
    and equals ``table[clamp_ids(ids)]``; the CUDA context stays usable
    (a synchronize and a further launch pass).  Raw out-of-range ids never
    go to ``table[ids]`` on the card: its device assert would poison the
    context."""
    from repro_torch.kernels import gather

    v = 1000
    table = torch.randn((v, 66), dtype=torch.float32, device=cuda_device)
    raw = [v, v + 7, -1, -v - 3, 2**31 - 1, 3, -v]
    if id_dtype == torch.int64:
        raw += [2**31, -2**31 - 5]
    ids = torch.tensor(raw, dtype=id_dtype, device=cuda_device)
    got = gather.embedding_gather(table, ids)
    torch.cuda.synchronize()
    rows = gather.clamp_ids(ids, v)
    assert torch.equal(got, table[rows])
    assert torch.equal(got, gather.embedding_gather_ref(table, ids))
    ok = torch.tensor([0, v - 1], dtype=id_dtype, device=cuda_device)
    assert torch.equal(gather.embedding_gather(table, ok), table[ok.long()])
    torch.cuda.synchronize()


@pytest.mark.cuda
@pytest.mark.parametrize("t", [4, 512])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gather_shard_form_equals_plain_version(cuda_device, dtype, id_dtype, t):
    """B9's vocab-shard form on four row shards of a table: each shard
    ``torch.equal`` to ``embedding_gather_shard_ref``, one launch a call,
    and the shards' sum equal to the whole-table gather; the ids hold every
    shard's first and last rows and card ids outside ``[0, V)`` (bounded by
    the whole V: an id past V reads row V - 1 from the last shard only)."""
    from repro_torch.kernels import gather

    v, d, n = 4000, 66, 4
    rows = v // n
    table = torch.randn((v, d), dtype=dtype, device=cuda_device)
    edges = [e for k in range(n) for e in (k * rows, (k + 1) * rows - 1)]
    raw = edges + [v, v + 7, -1, -v - 3, 2**31 - 1, -v]
    rng = np.random.default_rng(t)
    raw += rng.integers(0, v, t - len(raw)).tolist() if t > len(raw) else []
    ids = torch.tensor(raw[:t] if t < len(raw) else raw, dtype=id_dtype,
                       device=cuda_device)
    parts = []
    for k in range(n):
        shard = table[k * rows:(k + 1) * rows]
        before = gather.SHARD_LAUNCHES
        got = gather.embedding_gather_shard(shard, ids, k * rows, v)
        torch.cuda.synchronize()
        assert gather.SHARD_LAUNCHES == before + 1
        assert torch.equal(got, gather.embedding_gather_shard_ref(
            shard, ids, k * rows, v))
        parts.append(got)
    assert torch.equal(sum(parts[1:], parts[0]), gather.embedding_gather_ref(table, ids))
    host = rng.integers(0, v, t).astype(np.int32)        # scanned, then uploaded
    assert torch.equal(gather.embedding_gather_shard(table[rows:2 * rows], host,
                                                     rows, v),
                       gather.embedding_gather_shard_ref(
                           table[rows:2 * rows], torch.from_numpy(host), rows, v))


@pytest.mark.cuda
@pytest.mark.parametrize("t", [4, 512, 3000])
@pytest.mark.parametrize("id_dtype", [torch.int32, torch.int64])
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
def test_gather_shard_backward_equals_plain_version(cuda_device, dtype,
                                                    id_dtype, t):
    """B9's shard backward on four row shards: each ``torch.equal`` to
    ``embedding_gather_shard_bwd_ref``, one launch a call, the four
    stacked ``torch.equal`` to the whole-table backward; ids on every
    shard boundary, repeated, past V and below 0 (bounded by the whole V);
    a window no id hits is all zeros."""
    from repro_torch.kernels import gather

    v, d, n = 4000, 66, 4
    rows = v // n
    edges = [e for k in range(n) for e in (k * rows, (k + 1) * rows - 1)]
    raw = edges + [v, v + 7, -1, -v - 3, 2**31 - 1, -v, 5, 5, 5]
    rng = np.random.default_rng(t)
    raw += rng.integers(0, v, max(t - len(raw), 0)).tolist()
    ids = torch.tensor(raw[:t], dtype=id_dtype, device=cuda_device)
    dout = torch.randn((t, d), dtype=dtype, device=cuda_device)
    parts = []
    for k in range(n):
        before = gather.SHARD_BWD_LAUNCHES
        got = gather.embedding_gather_shard_bwd(dout, ids, k * rows, rows, v)
        torch.cuda.synchronize()
        assert gather.SHARD_BWD_LAUNCHES == before + 1
        assert torch.equal(got, gather.embedding_gather_shard_bwd_ref(
            dout, ids, k * rows, rows, v))
        parts.append(got)
    assert torch.equal(torch.cat(parts), gather.embedding_gather_bwd(dout, ids, v))
    low = torch.tensor([0, 1, 2, 3] * (t // 4 or 1), dtype=id_dtype,
                       device=cuda_device)[:t]
    empty = gather.embedding_gather_shard_bwd(dout[:low.shape[0]], low, 2 * rows,
                                              rows, v)
    assert not empty.any()


@pytest.mark.cuda
def test_gather_shard_backward_refuses_before_any_launch(cuda_device):
    """A window outside the vocabulary is refused by the launch plan
    before any launch."""
    from repro_torch.analysis import LaunchPlanError
    from repro_torch.kernels import gather

    dout = torch.randn((8, 16), device=cuda_device)
    ids = torch.zeros(8, dtype=torch.int64, device=cuda_device)
    before = gather.SHARD_BWD_LAUNCHES
    with pytest.raises(LaunchPlanError, match="outside the vocabulary"):
        gather.embedding_gather_shard_bwd(dout, ids, 90, 20, 100)
    assert gather.SHARD_BWD_LAUNCHES == before


@pytest.mark.cuda
@pytest.mark.parametrize("shape", [(1, 4), (2, 2)])
def test_reduced_mamba2_train_step_on_a_card_mesh(cuda_device, shape):
    """The reduced mamba2's train step on a mesh naming the card four times
    (B8 a head shard, B9's shard form and its backward) against the
    unsharded step on the card: loss 1e-5 relative, gradients 1e-4 x
    max|g|; every block's pieces equal after AdamW."""
    from repro_torch import configs
    from repro_torch.compat import make_mesh
    from repro_torch.kernels import gather, ssd
    from repro_torch.models import model as M
    from repro_torch.models import sharding
    from repro_torch.train import TrainConfig, init_train_state, make_train_step
    from repro_torch.train.step import loss_and_grads

    cfg = configs.reduced_config("mamba2-2.7b")
    lm = M.init_params(M.make_generator(0, cuda_device), cfg, trainable=True)
    mesh = make_mesh(shape, ("data", "model"), (cuda_device,) * 4)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, 256, (4, 16)).astype(np.int32),
             "labels": rng.integers(0, 256, (4, 16)).astype(np.int32)}
    tc = TrainConfig(remat="full")
    want, wl, _ = loss_and_grads(lm, cfg, tc, batch)
    placed = sharding.place_params(lm, cfg, mesh)
    counts = (ssd.KERNEL_LAUNCHES, ssd.BWD_LAUNCHES, gather.SHARD_LAUNCHES,
              gather.SHARD_BWD_LAUNCHES)
    got, gl, _ = loss_and_grads(placed, cfg, tc, batch)
    torch.cuda.synchronize()
    ran = [a - b for a, b in zip((ssd.KERNEL_LAUNCHES, ssd.BWD_LAUNCHES,
                                  gather.SHARD_LAUNCHES,
                                  gather.SHARD_BWD_LAUNCHES), counts)]
    assert all(ran), ran
    assert float(gl) == pytest.approx(float(wl), rel=1e-5)
    for k, g in want.items():
        tol = 1e-4 * max(float(g.abs().max()), 1e-30)
        torch.testing.assert_close(got[k].full(), g, rtol=0, atol=tol)
    state, _ = make_train_step(cfg, tc)(init_train_state(None, cfg, tc,
                                                         params=placed), batch)
    for _, leaf in state.params.items():
        for grp in sharding.groups(leaf):
            for c in grp:
                assert torch.equal(leaf.pieces[c], leaf.pieces[grp[0]])


@pytest.mark.cuda
def test_ell_kernels_bound_handed_live_widths(cuda_device):
    """B4 / B5 / B6 with live widths W + 5 in every warp are torch.equal to
    the true widths; -1 in one warp walks no slot there, torch.equal to the
    plain path handed the same widths (which cuts the slab as the kernel
    walks it)."""
    from repro_torch.graphs import gen as G
    from repro_torch.kernels import bfs, pagerank, spmv

    csr = F.random_csr(4093, 3000, 9.0, seed=6, skew=1.2)
    cols, vals = F.csr_to_ellpack(csr, c=32).to_device(cuda_device)
    x = torch.from_numpy(np.random.default_rng(0).standard_normal(3000)) \
        .to(cuda_device)
    X = torch.from_numpy(np.random.default_rng(1).standard_normal((3000, 8))) \
        .to(cuda_device)
    live = spmv.live_widths(cols)
    over = torch.full_like(live, cols.shape[1] + 5)
    neg = live.clone()
    neg[1] = -1
    for fn, rhs in ((spmv.spmv_ell, x), (spmv.spmm_ell, X)):
        want = fn(cols, vals, rhs, live_width=live)
        assert torch.equal(fn(cols, vals, rhs, live_width=over), want)
        got = fn(cols, vals, rhs, live_width=neg)
        plain = fn(cols.cpu(), vals.cpu(), rhs.cpu(), live_width=neg.cpu())
        assert not got[32:64].any()
        torch.testing.assert_close(got.cpu(), plain, rtol=1e-10, atol=1e-10)
    g, rg = _graph_case(G, n=4093)
    radj = rg.to_device(cuda_device)
    live = bfs.ell_live_widths(radj)
    over = torch.full_like(live, radj.shape[1] + 5)
    neg = live.clone()
    neg[2] = -1
    d = torch.full((4093,), G.INF, dtype=torch.int32, device=cuda_device)
    d[np.random.default_rng(2).choice(4093, 40, replace=False)] = 0
    contrib = torch.from_numpy(np.random.default_rng(4).random(4093)).to(
        cuda_device)
    consts = torch.tensor([0.15 / 4093, 0.85, 1e-5], dtype=torch.float64,
                          device=cuda_device)
    want_b = bfs.bfs_step(radj, d, 1, live_width=live)
    want_p = pagerank.pagerank_step(radj, contrib, consts, live_width=live)
    assert torch.equal(bfs.bfs_step(radj, d, 1, live_width=over), want_b)
    assert torch.equal(pagerank.pagerank_step(radj, contrib, consts,
                                              live_width=over), want_p)
    got_b = bfs.bfs_step(radj, d, 1, live_width=neg)
    assert torch.equal(got_b.cpu(), bfs.bfs_step(
        radj.cpu(), d.cpu(), 1, live_width=neg.cpu()))
    got_p = pagerank.pagerank_step(radj, contrib, consts, live_width=neg)
    torch.testing.assert_close(got_p.cpu(), pagerank.pagerank_step(
        radj.cpu(), contrib.cpu(), consts.cpu(), live_width=neg.cpu()),
        rtol=1e-10, atol=0)
    torch.cuda.synchronize()


def _ssd_case(b, l, h, p, g, n, dtype, device, seed, init=False):
    rng = np.random.default_rng(seed)
    arrs = [rng.standard_normal((b, l, h, p)),
            -np.abs(rng.standard_normal((b, l, h))) * 0.3,
            rng.standard_normal((b, l, g, n)), rng.standard_normal((b, l, g, n))]
    if init:
        arrs.append(rng.standard_normal((b, h, p, n)))
    out = [torch.from_numpy(a.astype(dtype)).to(device) for a in arrs]
    return out[:4], (out[4] if init else None)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype,tol", [(np.float32, 2e-4), (np.float64, 1e-10)])
@pytest.mark.parametrize("shape,chunk", [
    ((2, 64, 4, 8, 2, 16), 16),          # the reference's test shape, g = 2
    ((1, 64, 4, 32, 1, 16), 64),         # l == chunk
    ((1, 192, 4, 72, 2, 80), 64),        # 3 chunks, ragged p and n tiles
    ((1, 300, 3, 8, 1, 16), 100),        # ragged query tiles
    ((1, 512, 80, 64, 1, 128), 256),     # mamba2-2.7b's prefill
    ((1, 512, 50, 64, 1, 16), 256),      # hymba-1.5b's: n 16 below the k step
    ((4, 512, 50, 64, 1, 16), 256),      # hymba's engine prefill
    ((1, 2560, 50, 64, 1, 16), 256),     # hymba past its 2048-token window
])
def test_ssd_kernel_matches_plain_version(cuda_device, dtype, tol, shape, chunk):
    """B8 against its plain version on the card, from zero and from a random
    initial state, at the reference's tolerances (``tests/test_kernels.py``:
    2e-4 fp32, 1e-10 fp64), fp32's absolute part taken relative to
    max(1, max|y|): at mamba2's widths y sums 256 x 128 products and
    reaches |y| ~ 1e2, where fp32 rounding in another summation order alone
    exceeds 2e-4."""
    from repro_torch.kernels import ssd

    for init in (False, True):
        (xd, ad, B, C), s0 = _ssd_case(*shape, dtype, cuda_device, chunk, init)
        before = ssd.KERNEL_LAUNCHES
        y, f = ssd.ssd_fused(xd, ad, B, C, chunk=chunk, init_state=s0)
        torch.cuda.synchronize()
        assert ssd.KERNEL_LAUNCHES == before + ssd.LAUNCHES_PER_CALL
        y0, f0 = ssd.ssd_fused_ref(xd, ad, B, C, chunk=chunk, init_state=s0)
        for got, want in ((y, y0), (f, f0)):
            scale = max(1.0, float(want.abs().max())) if dtype == np.float32 \
                else 1.0
            torch.testing.assert_close(got, want, rtol=tol, atol=tol * scale)


@pytest.mark.cuda
def test_refused_ssd_launch_raises_and_leaves_no_error_behind(cuda_device):
    """A B8 call whose chunk does not divide the sequence is refused: the
    wrapper's plan raises before launching, a forced launch is refused by
    the kernel's own check and raises instead of returning garbage,
    counting nothing, and the next call runs clean."""
    from repro_torch.analysis import LaunchPlanError
    from repro_torch.kernels import ssd

    (xd, ad, B, C), _ = _ssd_case(1, 96, 2, 64, 1, 128, np.float64,
                                  cuda_device, 0)
    with pytest.raises(LaunchPlanError, match="multiple of the chunk"):
        ssd.ssd_fused(xd, ad, B, C, chunk=64)
    y = torch.empty_like(xd)
    f = torch.empty((1, 2, 64, 128), dtype=xd.dtype, device=cuda_device)
    before = ssd.KERNEL_LAUNCHES
    with pytest.raises(RuntimeError, match="cudaError"):
        ssd._launch(xd, ad, B, C, None, y, f, 64)
    assert ssd.KERNEL_LAUNCHES == before
    (xd, ad, B, C), _ = _ssd_case(1, 256, 2, 64, 1, 512, np.float64,
                                  cuda_device, 1)
    got, fs = ssd.ssd_fused(xd, ad, B, C, chunk=256)   # d_state 512 runs
    torch.cuda.synchronize()
    assert ssd.KERNEL_LAUNCHES == before + ssd.LAUNCHES_PER_CALL
    want, fw = ssd.ssd_fused_ref(xd, ad, B, C, chunk=256)
    torch.testing.assert_close(got, want, rtol=1e-10, atol=1e-10)
    torch.testing.assert_close(fs, fw, rtol=1e-10, atol=1e-10)


def _ssd_bwd_tol(dtype, want) -> float:
    """B8's backward tolerance: fp64 1e-10; fp32 the forward's 2e-4 times
    max(1, max|grad|) of the output (sums of 256 x 128 products in another
    order, as the forward's)."""
    if dtype == np.float64:
        return 1e-10
    return 2e-4 * max(1.0, float(want.abs().max()))


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape,chunk", [
    ((2, 64, 4, 8, 2, 16), 16),          # g = 2: dB, dC summed over 2 heads
    ((1, 192, 4, 72, 2, 80), 64),        # 3 chunks, ragged p and n tiles
    ((1, 300, 3, 8, 1, 16), 100),        # ragged query and key tiles
    ((2, 512, 80, 64, 1, 128), 256),     # mamba2-2.7b's train step
    ((1, 512, 50, 64, 1, 16), 256),      # hymba-1.5b's
])
def test_ssd_backward_kernel_matches_plain_version(cuda_device, dtype, shape,
                                                   chunk):
    """B8's backward against its plain version on the card, from a zero and
    a random initial state, with and without a final-state gradient; two
    calls bit-equal; the launches counted five a call."""
    from repro_torch.kernels import ssd

    for init, fin in ((False, False), (True, True)):
        (xd, ad, B, C), s0 = _ssd_case(*shape, dtype, cuda_device, chunk, init)
        rng = np.random.default_rng(chunk + 1)
        b, l, h, p, g, n = shape
        dy = torch.from_numpy(rng.standard_normal((b, l, h, p)).astype(dtype)
                              ).to(cuda_device)
        df = (torch.from_numpy(rng.standard_normal((b, h, p, n)).astype(dtype)
                               ).to(cuda_device) if fin else None)
        before = ssd.BWD_LAUNCHES
        got = ssd.ssd_fused_bwd(xd, ad, B, C, dy, df, chunk=chunk,
                                init_state=s0)
        again = ssd.ssd_fused_bwd(xd, ad, B, C, dy, df, chunk=chunk,
                                  init_state=s0)
        torch.cuda.synchronize()
        assert ssd.BWD_LAUNCHES == before + 2 * ssd.LAUNCHES_PER_BWD
        want = ssd.ssd_fused_bwd_ref(xd, ad, B, C, dy, df, chunk=chunk,
                                     init_state=s0)
        assert (got[4] is None) == (s0 is None)
        for gv, av, wv in zip(got, again, want):
            if gv is None:
                continue
            assert torch.equal(gv, av)
            tol = _ssd_bwd_tol(dtype, wv)
            torch.testing.assert_close(gv, wv.to(gv.dtype), rtol=tol, atol=tol)


@pytest.mark.cuda
def test_ssd_autograd_on_the_card_runs_both_kernels(cuda_device):
    """A gradient through ``ssd_fused`` on the card launches the forward's
    three and the backward's five, and equals autograd of the plain
    version."""
    from repro_torch.kernels import ssd

    (xd, ad, B, C), s0 = _ssd_case(1, 128, 4, 16, 2, 16, np.float64,
                                   cuda_device, 3, init=True)
    ins = [t.clone().requires_grad_() for t in (xd, ad, B, C, s0)]
    f0, b0 = ssd.KERNEL_LAUNCHES, ssd.BWD_LAUNCHES
    y, f = ssd.ssd_fused(*ins[:4], chunk=32, init_state=ins[4])
    got = torch.autograd.grad(y.square().sum() + f.sum(), ins)
    torch.cuda.synchronize()
    assert ssd.KERNEL_LAUNCHES - f0 == ssd.LAUNCHES_PER_CALL
    assert ssd.BWD_LAUNCHES - b0 == ssd.LAUNCHES_PER_BWD
    y1, f1 = ssd.ssd_fused_ref(*ins[:4], chunk=32, init_state=ins[4])
    want = torch.autograd.grad(y1.square().sum() + f1.sum(), ins)
    for gv, wv in zip(got, want):
        torch.testing.assert_close(gv, wv, rtol=1e-10, atol=1e-10)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("t,vocab,d", [(1024, 50280, 2560), (4, 50280, 2560),
                                       (300, 97, 24)])
def test_gather_backward_kernel_equals_plain_version(cuda_device, dtype, t,
                                                     vocab, d):
    """B9's backward equals its plain version exactly (the same sums in the
    same order) with repeated ids, and ``index_add_`` to 1e-6 x max; one
    launch a call; through autograd too."""
    from repro_torch.kernels import gather

    g = torch.Generator(device=cuda_device).manual_seed(t)
    ids = torch.randint(0, min(vocab, 64), (t,), device=cuda_device,
                        generator=g)
    dout = torch.randn((t, d), dtype=dtype, device=cuda_device, generator=g)
    before = gather.BWD_LAUNCHES
    got = gather.embedding_gather_bwd(dout, ids, vocab)
    torch.cuda.synchronize()
    assert gather.BWD_LAUNCHES == before + 1
    assert torch.equal(got, gather.embedding_gather_bwd_ref(dout, ids, vocab))
    lib = torch.zeros((vocab, d), dtype=dtype, device=cuda_device
                      ).index_add_(0, ids, dout)
    torch.testing.assert_close(got, lib, rtol=0,
                               atol=1e-6 * float(lib.abs().max()))
    table = torch.randn((vocab, d), dtype=dtype, device=cuda_device,
                        generator=g, requires_grad=True)
    out = gather.embedding_gather(table, ids)
    (dt,) = torch.autograd.grad(out, table, dout)
    assert torch.equal(dt, got)


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
@pytest.mark.parametrize("shape,chunk", [
    ((2, 512, 80, 64, 1, 128), 256),     # mamba2-2.7b's train step
    ((1, 512, 50, 64, 1, 16), 256),      # hymba-1.5b's: n 16
    ((2, 192, 4, 72, 2, 80), 64),        # g = 2, ragged p and n tiles
])
def test_ssd_backward_hands_each_tile_pair_once(cuda_device, dtype, shape, chunk):
    """B8's key launch computes each (query, key) tile pair's C Bᵀ and dY Xᵀ
    once and hands the query launch M = (dY Xᵀ) ∘ L and the pair's row sums
    of C Bᵀ ∘ M: those handed tiles against a plain computation (fp64
    1e-10; fp32 2e-4 x max(1, max|M|)), zero above the diagonal, and the
    launches' gradients bit-equal over two calls."""
    from repro_torch.core import autotune
    from repro_torch.kernels import cuda_lib, ssd

    b, l, h, p, g, n = shape
    (xd, ad, B, C), _ = _ssd_case(*shape, dtype, cuda_device, chunk)
    dy = torch.from_numpy(np.random.default_rng(chunk + 2).standard_normal(
        (b, l, h, p)).astype(dtype)).to(cuda_device)
    _, fstate, cum, entering = ssd._forward(xd, ad, B, C, chunk, None, keep=True)
    lib = cuda_lib.library("ssd_bwd")
    outs = []
    for _ in range(2):
        buf = ssd._BwdBuffers(xd, B, None, chunk)
        calls = ssd._bwd_calls(lib, xd, B, C, dy, None, None, fstate, cum, entering,
                               chunk, buf, torch.cuda.current_stream().cuda_stream)
        for name in autotune.SSD_BWD_LAUNCHES:
            assert calls[name]() == 0, name
        outs.append(buf)
    torch.cuda.synchronize()
    for k in ("dx", "dad", "dB", "dC", "mh", "rh"):
        assert torch.equal(outs[0][k], outs[1][k]), k
    nc, t, hg = l // chunk, -(-chunk // 64), h // g
    pairs = t * (t + 1) // 2
    mh = outs[0]["mh"].view(b, h, nc, pairs, 64, 64)
    rh = outs[0]["rh"].view(b, h, nc, pairs, 64)
    grp = torch.arange(h, device=cuda_device) // hg
    pad = t * 64
    x = torch.zeros((b, h, nc, pad, p), dtype=xd.dtype, device=cuda_device)
    x[:, :, :, :chunk] = xd.reshape(b, nc, chunk, h, p).permute(0, 3, 1, 2, 4)
    dyc = torch.zeros_like(x)
    dyc[:, :, :, :chunk] = dy.reshape(b, nc, chunk, h, p).permute(0, 3, 1, 2, 4)
    bb = torch.zeros((b, h, nc, pad, n), dtype=xd.dtype, device=cuda_device)
    cc = torch.zeros_like(bb)
    bb[:, :, :, :chunk] = B[:, :, grp].reshape(b, nc, chunk, h, n).permute(0, 3, 1, 2, 4)
    cc[:, :, :, :chunk] = C[:, :, grp].reshape(b, nc, chunk, h, n).permute(0, 3, 1, 2, 4)
    cm = torch.zeros((b, h, nc, pad), dtype=xd.dtype, device=cuda_device)
    cm[..., :chunk] = cum.view(b, h, nc, chunk)
    idx = torch.arange(pad, device=cuda_device)
    live = (idx[:, None] >= idx[None, :]) & (idx[:, None] < chunk)
    lmat = torch.where(live, torch.exp(torch.where(
        live, cm[..., :, None] - cm[..., None, :], 0)), 0)
    m = (dyc @ x.transpose(-1, -2)) * lmat
    gm = cc @ bb.transpose(-1, -2)
    rows = (gm * m)
    tol = 1e-10 if dtype == np.float64 else 2e-4
    for i in range(t):
        for j in range(i + 1):
            k = i * (i + 1) // 2 + j
            want = m[..., i * 64:(i + 1) * 64, j * 64:(j + 1) * 64]
            scale = 1.0 if dtype == np.float64 else max(1.0, float(want.abs().max()))
            torch.testing.assert_close(mh[:, :, :, k], want, rtol=tol, atol=tol * scale)
            if i == j:
                assert not mh[:, :, :, k].triu(1).any()
            wr = rows[..., i * 64:(i + 1) * 64, j * 64:(j + 1) * 64].sum(-1)
            scale = 1.0 if dtype == np.float64 else max(1.0, float(wr.abs().max()))
            torch.testing.assert_close(rh[:, :, :, k], wr, rtol=tol, atol=tol * scale)


def _zipf_ids(rng, t, vocab, run=0):
    """A Zipf-like stream (rank r drawn ~ 1 / (r + 1)) with ``run`` extra ids
    on token 0, shuffled."""
    w = 1.0 / np.arange(1, vocab + 1)
    ids = rng.choice(vocab, size=t - run, p=w / w.sum())
    ids = np.concatenate([ids, np.zeros(run, ids.dtype)])
    rng.shuffle(ids)
    return ids


@pytest.mark.cuda
@pytest.mark.parametrize("dtype", [torch.float32, torch.float64])
@pytest.mark.parametrize("case", ["equal", "zipf", "card_range", "t1", "t8192"])
def test_gather_backward_kernel_edge_cases(cuda_device, dtype, case):
    """B9's backward (one launch, no sort) equals its plain version on
    all-equal ids (one run of every id), a Zipf stream with a 200-id run on
    token 0, card ids outside [0, V) (bounded as the forward bounds them),
    T = 1 and T = 8192 (four slices of ids) at mamba2's table shape, int32
    and int64 ids; two calls bit-equal."""
    from repro_torch.kernels import gather

    vocab, d = 50280, 2560
    rng = np.random.default_rng(len(case))
    t = {"t1": 1, "t8192": 8192}.get(case, 1024)
    if case == "equal":
        ids = np.full(t, 777)
    elif case == "zipf":
        ids = _zipf_ids(rng, t, vocab, run=200)
    elif case == "card_range":
        ids = rng.integers(-2 * vocab, 2 * vocab, t)
        ids[:4] = (-1, vocab, -vocab - 5, 2**40)
    else:
        ids = _zipf_ids(rng, t, vocab)
    dout = torch.from_numpy(rng.standard_normal((t, d))).to(dtype=dtype,
                                                            device=cuda_device)
    want = gather.embedding_gather_bwd_ref(dout, torch.from_numpy(ids).to(cuda_device),
                                           vocab)
    for id_dtype in (torch.int64, torch.int32):
        if id_dtype == torch.int32 and np.abs(ids).max() >= 2**31:
            continue
        tid = torch.from_numpy(ids).to(dtype=id_dtype, device=cuda_device)
        before = gather.BWD_LAUNCHES
        got = gather.embedding_gather_bwd(dout, tid, vocab)
        again = gather.embedding_gather_bwd(dout, tid, vocab)
        torch.cuda.synchronize()
        assert gather.BWD_LAUNCHES == before + 2
        assert torch.equal(got, again)
        assert torch.equal(got, want), (case, id_dtype)


@pytest.mark.cuda
def test_reduced_mamba2_train_step_on_the_card_as_on_the_cpu(cuda_device):
    """One train step of the reduced mamba2 (its scans chunk multiples): the
    card's loss and gradients (B8, B9 and their backward kernels) against
    the CPU's (plain versions), loss 1e-5 relative, each gradient 1e-4 x
    max|g|; the same under remat "full"."""
    from repro_torch import configs
    from repro_torch.kernels import gather, ssd
    from repro_torch.models import model as M
    from repro_torch.train import TrainConfig
    from repro_torch.train.step import loss_and_grads

    cfg = configs.reduced_config("mamba2-2.7b")
    cpu = M.init_params(M.make_generator(0, "cpu"), cfg, trainable=True)
    card = copy.deepcopy(cpu).to(cuda_device)
    rng = np.random.default_rng(1)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 32)),
             "labels": rng.integers(0, cfg.vocab_size, (2, 32))}
    want, lw, _ = loss_and_grads(cpu, cfg, TrainConfig(remat=None), batch)
    for remat in (None, "full"):
        counts = (ssd.KERNEL_LAUNCHES, ssd.BWD_LAUNCHES, gather.KERNEL_LAUNCHES,
                  gather.BWD_LAUNCHES)
        got, lg, _ = loss_and_grads(card, cfg, TrainConfig(remat=remat), batch)
        torch.cuda.synchronize()
        fwd = cfg.n_layers * ssd.LAUNCHES_PER_CALL * (2 if remat else 1)
        assert (ssd.KERNEL_LAUNCHES - counts[0], ssd.BWD_LAUNCHES - counts[1],
                gather.KERNEL_LAUNCHES - counts[2], gather.BWD_LAUNCHES - counts[3]
                ) == (fwd, cfg.n_layers * ssd.LAUNCHES_PER_BWD, 1, 1)
        assert float(lg) == pytest.approx(float(lw), rel=1e-5)
        for k, g in want.items():
            tol = 1e-4 * max(float(g.abs().max()), 1e-30)
            torch.testing.assert_close(got[k].cpu(), g, rtol=0, atol=tol)


@pytest.mark.cuda
def test_reduced_mamba2_serves_on_the_card_as_on_the_cpu(cuda_device):
    """The LM path with the same weights on the card (B8, B9) and on the
    CPU (plain versions): prefill and decode logits at 1e-5 x max|logit|,
    and the engine's greedy tokens equal."""
    from repro_torch import configs
    from repro_torch.kernels import gather, ssd
    from repro_torch.models import model as M
    from repro_torch.serve import GenerationConfig, ServeEngine

    cfg = configs.reduced_config("mamba2-2.7b")
    cpu = M.init_params(M.make_generator(0, "cpu"), cfg)
    card = copy.deepcopy(cpu).to(cuda_device)       # Module.to moves in place
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 16))
    b8, b9 = ssd.KERNEL_LAUNCHES, gather.KERNEL_LAUNCHES
    outs = []
    for p, dev in ((cpu, "cpu"), (card, cuda_device)):
        caches = M.init_caches(cfg, 2, 64, dtype=torch.float32, device=dev)
        logits, caches = M.prefill(p, cfg, {"tokens": prompts}, caches)
        step, _ = M.decode_step(p, cfg, prompts[:, :1], caches)
        outs.append((logits.cpu(), step.cpu()))
    assert ssd.KERNEL_LAUNCHES - b8 == cfg.n_layers * ssd.LAUNCHES_PER_CALL
    assert gather.KERNEL_LAUNCHES - b9 == 2
    for want, got in zip(*outs):
        tol = 1e-5 * float(want.abs().max())
        torch.testing.assert_close(got, want, rtol=0, atol=tol)
    gcfg = GenerationConfig(max_new_tokens=6, cache_len=64)
    np.testing.assert_array_equal(ServeEngine(cfg, card, gcfg).generate(prompts),
                                  ServeEngine(cfg, cpu, gcfg).generate(prompts))


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["llama3.2-3b", "qwen2-1.5b", "qwen3-14b",
                                  "minicpm-2b"])
def test_reduced_dense_lms_serve_on_the_card_as_on_the_cpu(cuda_device, arch):
    """A dense attention LM with the same weights on the card (B9, the
    attention and MLP in plain torch) and on the CPU: prefill and decode
    logits and the KV caches at 1e-5 x max|value|, the engine's and the
    batcher's greedy tokens equal; B9 once a prefill and once a step."""
    from repro_torch import configs
    from repro_torch.kernels import gather
    from repro_torch.models import model as M
    from repro_torch.serve import Batcher, GenerationConfig, Request, ServeEngine

    cfg = configs.reduced_config(arch)
    cpu = M.init_params(M.make_generator(0, "cpu"), cfg)
    card = copy.deepcopy(cpu).to(cuda_device)
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 16))
    b9 = gather.KERNEL_LAUNCHES
    outs = []
    for p, dev in ((cpu, "cpu"), (card, cuda_device)):
        caches = M.init_caches(cfg, 2, 64, dtype=torch.float32, device=dev)
        logits, caches = M.prefill(p, cfg, {"tokens": prompts}, caches)
        step, caches = M.decode_step(p, cfg, prompts[:, :1], caches)
        kv = caches["layers"].kv
        outs.append((logits.cpu(), step.cpu(), kv.k.cpu(), kv.v.cpu()))
        assert kv.length.tolist() == [17] * cfg.n_layers
    assert gather.KERNEL_LAUNCHES - b9 == 2
    for want, got in zip(*outs):
        tol = 1e-5 * max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got, want, rtol=0, atol=tol)
    gcfg = GenerationConfig(max_new_tokens=6, cache_len=64)
    np.testing.assert_array_equal(ServeEngine(cfg, card, gcfg).generate(prompts),
                                  ServeEngine(cfg, cpu, gcfg).generate(prompts))
    served = []
    for p in (cpu, card):
        b = Batcher(cfg, p, n_slots=2, gcfg=gcfg)
        for i, pr in enumerate(np.concatenate([prompts, prompts[::-1]])):
            b.submit(Request(rid=i, prompt=pr.astype(np.int32), max_new_tokens=4))
        served.append({r.rid: r.generated for r in b.run()})
    assert served[0] == served[1]


@pytest.mark.cuda
def test_fp32_envelope_combine_runs_b1_as_the_plain_version(cuda_device):
    """A float32 MoE envelope on the card: the service's combine launches
    B1 (one launch a width bucket) and returns float32 within 1e-4 x
    max|y| of the plain version on the same routing; the expert-output
    tensor goes in on the card as it is."""
    from repro_torch.service import KernelRegistry, KernelService

    rng = np.random.default_rng(7)
    n_tok, n_slots, top_k, d = 96, 4 * 64, 6, 256
    indptr, indices = [0], []
    for _ in range(n_tok):
        indices += sorted(rng.choice(n_slots, size=top_k, replace=False).tolist())
        indptr.append(len(indices))
    csr = F.CSRMatrix(indptr=np.asarray(indptr, np.int64),
                      indices=np.asarray(indices, np.int32),
                      data=rng.random(len(indices)).astype(np.float32),
                      n_cols=n_slots)
    x = torch.from_numpy(rng.standard_normal((n_slots, d)).astype(np.float32)
                         ).to(cuda_device)
    reg = KernelRegistry()
    reg.register_moe("moe", n_tokens=n_tok, n_slots=n_slots, d_model=d,
                     top_k=top_k, dtype="float32")
    svc = KernelService(reg, n_slots=2)
    before = sell_core.KERNEL_LAUNCHES
    rid = svc.submit("moe_dispatch", "moe", {"indptr": csr.indptr,
                                             "indices": csr.indices,
                                             "data": csr.data, "x": x})
    svc.drain()
    y = svc.poll(rid)
    assert sell_core.KERNEL_LAUNCHES > before
    assert y.dtype == torch.float32 and y.device.type == "cuda"
    cols, vals, rows = F.csr_to_sell_slabs(csr, c=32).to_device(cuda_device)
    want = sell_core.spmm_sell_ref(cols, vals, rows, x, n_rows=n_tok)
    torch.testing.assert_close(y, want, rtol=0,
                               atol=1e-4 * float(want.abs().max()))


@pytest.mark.cuda
def test_reduced_deepseek_fused_engine_on_the_card(cuda_device):
    """Reduced deepseek-moe-16b on the card: the SELL combine (B1) against
    the dense path on the CPU at 1e-5 x max|out|, and the fused engine
    (a float32 envelope on the card) against the plain engine: equal
    greedy tokens, one ``moe_dispatch`` launch a MoE layer a step."""
    from repro_torch import configs
    from repro_torch.models import model as M
    from repro_torch.models import moe as MOE
    from repro_torch.serve import GenerationConfig, ServeEngine
    from repro_torch.service import KernelRegistry, KernelService

    cfg = configs.reduced_config("deepseek-moe-16b")
    cpu = M.init_params(M.make_generator(0, "cpu"), cfg)
    card = copy.deepcopy(cpu).to(cuda_device)
    x = np.random.default_rng(3).standard_normal((2, 16, cfg.d_model)
                                                 ).astype(np.float32)
    layer = card.blocks[0].moe
    before = sell_core.KERNEL_LAUNCHES
    got, _ = MOE.moe_forward(layer, cfg, torch.from_numpy(x).to(cuda_device),
                             spec=ExecSpec(dispatch="sell", vl=32))
    assert sell_core.KERNEL_LAUNCHES > before
    want, _ = MOE.moe_forward(cpu.blocks[0].moe, cfg, torch.from_numpy(x),
                              spec=ExecSpec(dispatch="dense"))
    torch.testing.assert_close(got.cpu(), want, rtol=0,
                               atol=1e-5 * float(want.abs().max()))
    prompts = np.random.default_rng(2).integers(0, cfg.vocab_size, (2, 16))
    gcfg = GenerationConfig(max_new_tokens=6, cache_len=64)
    plain = ServeEngine(cfg, card, gcfg).generate(prompts)
    m = cfg.moe
    cap = int(16 * m.top_k / m.n_experts * m.capacity_factor) + 1
    reg = KernelRegistry()
    reg.register_moe("moe", n_tokens=2 * 16, n_slots=2 * m.n_experts * cap,
                     d_model=cfg.d_model, top_k=m.top_k, dtype="float32")
    svc = KernelService(reg, n_slots=4)
    fused = ServeEngine(cfg, card, gcfg, kernel_service=svc,
                        moe_operand="moe").generate(prompts)
    np.testing.assert_array_equal(fused, plain)
    assert svc.stats["moe_dispatch_launches"] == \
        (cfg.n_layers - 1) * gcfg.max_new_tokens
    assert svc.metrics.get("latency_us_class_lm_token").count == \
        gcfg.max_new_tokens


# ---------------------------------------------------------------------------
# The sweep study's measured half (B4, B5, B6, B7 through ops)
# ---------------------------------------------------------------------------


@pytest.mark.cuda
def test_measure_cuda_times_each_kernel_on_the_card(cuda_device):
    from repro_torch.core import campaign as C
    from repro_torch.kernels import bfs as bfs_k
    from repro_torch.kernels import fft as fft_k
    from repro_torch.kernels import pagerank as pr_k
    from repro_torch.kernels import spmv as spmv_k

    before = (spmv_k.KERNEL_LAUNCHES, bfs_k.KERNEL_LAUNCHES["bfs_step"],
              pr_k.KERNEL_LAUNCHES["pagerank_step"],
              fft_k.KERNEL_LAUNCHES["fft_stockham_block"])
    outputs = {}
    recs = C.measure_cuda(vls=(64,), reps=2, campaign="t", outputs=outputs)
    after = (spmv_k.KERNEL_LAUNCHES, bfs_k.KERNEL_LAUNCHES["bfs_step"],
             pr_k.KERNEL_LAUNCHES["pagerank_step"],
             fft_k.KERNEL_LAUNCHES["fft_stockham_block"])
    assert [r["kernel"] for r in recs] == list(C.KERNELS)
    for r in recs:
        assert set(r) == {"campaign", "machine", "kernel", "vl",
                          "extra_latency", "bw_limit", "us_per_call",
                          "problem", "source"}
        assert (r["campaign"], r["vl"], r["source"]) == (
            "t", 64, "measured-cuda")
        assert r["machine"] == torch.cuda.get_device_name(0)
        assert r["us_per_call"] > 0 and "L2 flushed" in r["problem"]
    assert all(b < a for b, a in zip(before, after))
    assert all(out[0].is_cuda if isinstance(out, tuple) else out.is_cuda
               for out in outputs.values())


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["hymba-1.5b", "llama-3.2-vision-11b",
                                  "seamless-m4t-medium"])
def test_reduced_families_serve_on_the_card_as_on_the_cpu(cuda_device, arch):
    """The hybrid, vision and enc-dec LMs with the same weights on the
    card (B9; B8 in hymba's chunk-multiple prefill) and on the CPU: prefill
    logits with ``ctx_embeds`` (numpy, uploaded by the model) and a decode
    step reading the context back from the caches at 1e-5 x max|logit|,
    the engine's greedy tokens equal with ``extras`` and the batcher's
    without."""
    from repro_torch import configs
    from repro_torch.kernels import gather, ssd
    from repro_torch.models import model as M
    from repro_torch.serve import Batcher, GenerationConfig, Request, ServeEngine

    cfg = configs.reduced_config(arch)
    cpu = M.init_params(M.make_generator(0, "cpu"), cfg)
    card = copy.deepcopy(cpu).to(cuda_device)
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, cfg.vocab_size, (2, 16))
    ctx = None
    if cfg.encdec is not None:
        ctx = rng.standard_normal((2, cfg.encdec.n_ctx_tokens, cfg.d_model))
    elif cfg.cross_attn is not None:
        ctx = rng.standard_normal((2, cfg.cross_attn.n_ctx_tokens,
                                   cfg.cross_attn.d_ctx))
    batch = {"tokens": prompts}
    if ctx is not None:
        batch["ctx_embeds"] = ctx.astype(np.float32)
    b8, b9 = ssd.KERNEL_LAUNCHES, gather.KERNEL_LAUNCHES
    outs = []
    for p, dev in ((cpu, "cpu"), (card, cuda_device)):
        caches = M.init_caches(cfg, 2, 64, dtype=torch.float32, device=dev)
        logits, caches = M.prefill(p, cfg, batch, caches)
        step, _ = M.decode_step(p, cfg, prompts[:, :1], caches)
        outs.append((logits.cpu(), step.cpu()))
    assert ssd.KERNEL_LAUNCHES - b8 == (
        cfg.n_layers * ssd.LAUNCHES_PER_CALL if cfg.hybrid else 0)
    assert gather.KERNEL_LAUNCHES - b9 == 2
    for want, got in zip(*outs):
        tol = 1e-5 * max(1.0, float(want.abs().max()))
        torch.testing.assert_close(got, want, rtol=0, atol=tol)
    gcfg = GenerationConfig(max_new_tokens=6, cache_len=64)
    extras = None if ctx is None else {"ctx_embeds": batch["ctx_embeds"]}
    np.testing.assert_array_equal(
        ServeEngine(cfg, card, gcfg).generate(prompts, extras=extras),
        ServeEngine(cfg, cpu, gcfg).generate(prompts, extras=extras))
    served = []
    for p in (card, cpu):
        b = Batcher(cfg, p, n_slots=2, gcfg=gcfg)
        for i, pr in enumerate(prompts):
            b.submit(Request(rid=i, prompt=pr.astype(np.int32), max_new_tokens=4))
        served.append({r.rid: r.generated for r in b.run()})
    assert served[0] == served[1]


@pytest.mark.cuda
@pytest.mark.parametrize("arch", ["hymba-1.5b", "llama-3.2-vision-11b",
                                  "seamless-m4t-medium"])
def test_reduced_families_serve_on_a_mesh_of_the_card(cuda_device, arch):
    """The hybrid, vision and enc-dec LMs placed on (2, 2) and (1, 4)
    meshes naming the card four times against the same weights unsharded
    on the CPU: prefill logits with ``ctx_embeds`` and a decode step
    reading the context back from the placed caches at 1e-5 x max|logit|,
    B9's shard form launched (the reduced vocabulary divides), B8 in
    hymba's chunk-multiple prefill, and the engine's greedy tokens with
    ``extras`` equal to the CPU's."""
    from repro_torch import configs
    from repro_torch.compat import make_mesh
    from repro_torch.kernels import gather, ssd
    from repro_torch.models import model as M
    from repro_torch.models import sharding
    from repro_torch.serve import GenerationConfig, ServeEngine

    cfg = configs.reduced_config(arch)
    cpu = M.init_params(M.make_generator(0, "cpu"), cfg)
    rng = np.random.default_rng(2)
    prompts = rng.integers(0, cfg.vocab_size, (4, 16)).astype(np.int32)
    batch = {"tokens": prompts}
    if cfg.encdec is not None:
        batch["ctx_embeds"] = rng.standard_normal(
            (4, cfg.encdec.n_ctx_tokens, cfg.d_model)).astype(np.float32)
    elif cfg.cross_attn is not None:
        batch["ctx_embeds"] = rng.standard_normal(
            (4, cfg.cross_attn.n_ctx_tokens, cfg.cross_attn.d_ctx)).astype(np.float32)
    caches = M.init_caches(cfg, 4, 64, dtype=torch.float32, device="cpu")
    want, caches = M.prefill(cpu, cfg, batch, caches)
    want_step, _ = M.decode_step(cpu, cfg, prompts[:, :1], caches)
    gcfg = GenerationConfig(max_new_tokens=6, cache_len=64)
    extras = {k: v for k, v in batch.items() if k == "ctx_embeds"} or None
    want_toks = ServeEngine(cfg, cpu, gcfg).generate(prompts, extras=extras)
    for shape in ((2, 2), (1, 4)):
        mesh = make_mesh(shape, ("data", "model"), (cuda_device,) * 4)
        placed = sharding.place_params(cpu, cfg, mesh)
        b8, b9 = ssd.KERNEL_LAUNCHES, gather.SHARD_LAUNCHES
        caches = M.init_caches(cfg, 4, 64, dtype=torch.float32, mesh=mesh)
        got, caches = M.prefill(placed, cfg, batch, caches)
        step, _ = M.decode_step(placed, cfg, prompts[:, :1], caches)
        torch.cuda.synchronize()
        assert gather.SHARD_LAUNCHES > b9
        assert (ssd.KERNEL_LAUNCHES > b8) == bool(cfg.hybrid)
        for g, w in ((got, want), (step, want_step)):
            tol = 1e-5 * max(1.0, float(w.abs().max()))
            torch.testing.assert_close(g.cpu(), w, rtol=0, atol=tol)
        np.testing.assert_array_equal(
            ServeEngine(cfg, placed, gcfg, mesh=mesh).generate(prompts,
                                                               extras=extras),
            want_toks)


# ---------------------------------------------------------------------------
# The bf16 forms of B8 and B9: each against the fp32 form on the upcast
# inputs, rounded once (their contract: the fp32 form's arithmetic)
# ---------------------------------------------------------------------------


def _bf16_ssd_case(shape, device, chunk, init):
    """``_ssd_case``'s float32 inputs with xd / B / C rounded to bf16."""
    (xd, ad, B, C), s0 = _ssd_case(*shape, np.float32, device, chunk, init)
    return (xd.bfloat16(), ad, B.bfloat16(), C.bfloat16()), s0


@pytest.mark.cuda
@pytest.mark.parametrize("shape,chunk", [
    ((2, 64, 4, 8, 2, 16), 16),
    ((1, 192, 4, 72, 2, 80), 64),        # ragged p and n tiles
    ((2, 96, 6, 130, 2, 24), 32),        # p past one 64-column slice
    ((1, 512, 80, 64, 1, 128), 256),     # mamba2-2.7b's prefill
    ((1, 512, 50, 64, 1, 16), 256),      # hymba-1.5b's
])
def test_ssd_bf16_kernel_equals_fp32_form_rounded(cuda_device, shape, chunk):
    """B8's bf16 form (bf16 xd / B / C, float32 ad and initial state): y
    ``torch.equal`` to the fp32 form's on the upcast inputs rounded to
    bf16, the final state equal, from zero and from a random state; its
    backward's dxd / dB / dC the fp32 backward's rounded, dad and d
    init_state equal; three and five launches a call."""
    from repro_torch.kernels import ssd

    for init in (False, True):
        (xd, ad, B, C), s0 = _bf16_ssd_case(shape, cuda_device, chunk, init)
        up = (xd.float(), ad, B.float(), C.float())
        before = ssd.KERNEL_LAUNCHES
        y, f = ssd.ssd_fused(xd, ad, B, C, chunk=chunk, init_state=s0)
        torch.cuda.synchronize()
        assert ssd.KERNEL_LAUNCHES == before + ssd.LAUNCHES_PER_CALL
        y32, f32 = ssd.ssd_fused(*up, chunk=chunk, init_state=s0)
        assert y.dtype == torch.bfloat16 and torch.equal(y, y32.bfloat16())
        assert torch.equal(f, f32)
        dy = torch.randn_like(y32).bfloat16()
        df = torch.randn_like(f32)
        before = ssd.BWD_LAUNCHES
        got = ssd.ssd_fused_bwd(xd, ad, B, C, dy, df, chunk=chunk, init_state=s0)
        torch.cuda.synchronize()
        assert ssd.BWD_LAUNCHES == before + ssd.LAUNCHES_PER_BWD
        want = ssd.ssd_fused_bwd(*up, dy.float(), df, chunk=chunk, init_state=s0)
        for gv, wv in zip(got, want):
            if gv is not None:
                assert torch.equal(gv, wv.to(gv.dtype))


@pytest.mark.cuda
@pytest.mark.parametrize("d", [2560, 7])
@pytest.mark.parametrize("t", [4, 512, 4096])
def test_gather_bf16_forms_on_the_card(cuda_device, d, t):
    """B9's four bf16 entries: the gather and its shard form ``torch.equal``
    to ``table[clamp_ids(ids)]`` and to the masked rows (odd d: 2 B
    vectors), one launch a call; the backward and the shard backward, from
    bf16 and from float32 output gradients, ``torch.equal`` to the fp32
    backward's rounded once (t = 4096: two slices of ids, the float32
    carry); ids with repeats and card ids outside [0, V)."""
    from repro_torch.kernels import gather

    v = 1000
    table = torch.randn((v, d), device=cuda_device).bfloat16()
    rng = np.random.default_rng(t + d)
    ids = rng.integers(0, v, t)
    ids[::3] = ids[0]
    ids[:min(t, 4)] = [v + 3, -1, v - 1, -v - 7][:min(t, 4)]
    ids = torch.from_numpy(ids).to(cuda_device)
    before = gather.KERNEL_LAUNCHES
    got = gather.embedding_gather(table, ids)
    torch.cuda.synchronize()
    assert gather.KERNEL_LAUNCHES == before + 1
    assert torch.equal(got, table[gather.clamp_ids(ids, v)])
    parts = [gather.embedding_gather_shard(table[k * 250:(k + 1) * 250], ids,
                                           k * 250, v) for k in range(4)]
    assert torch.equal(sum(parts[1:], parts[0]), got)
    dout = torch.randn((t, d), device=cuda_device)
    for src, wide in ((dout.bfloat16(), dout.bfloat16().float()), (dout, dout)):
        before = gather.BWD_LAUNCHES
        g = gather.embedding_gather_bwd(src, ids, v, dtype=torch.bfloat16)
        torch.cuda.synchronize()
        assert gather.BWD_LAUNCHES == before + 1
        assert torch.equal(g, gather.embedding_gather_bwd(wide, ids, v).bfloat16())
        shards = [gather.embedding_gather_shard_bwd(src, ids, k * 250, 250, v,
                                                    dtype=torch.bfloat16)
                  for k in range(4)]
        assert torch.equal(torch.cat(shards), g)


@pytest.mark.cuda
def test_float16_is_refused_before_any_launch_on_the_card(cuda_device):
    """Float16 (no kernel form) is refused by every B8 / B9 wrapper before
    a launch; a bf16 mix other than the reference model's too."""
    from repro_torch.kernels import gather, ssd

    (xd, ad, B, C), _ = _bf16_ssd_case((1, 64, 4, 8, 1, 16), cuda_device, 16, False)
    counts = (ssd.KERNEL_LAUNCHES, gather.KERNEL_LAUNCHES, gather.BWD_LAUNCHES)
    with pytest.raises(TypeError):
        ssd.ssd_fused(xd.half(), ad, B.half(), C.half(), chunk=16)
    with pytest.raises(TypeError):
        ssd.ssd_fused(xd, ad.bfloat16(), B, C, chunk=16)
    with pytest.raises(TypeError):
        gather.embedding_gather(torch.zeros((10, 4), dtype=torch.float16,
                                            device=cuda_device), np.arange(3))
    with pytest.raises(TypeError):
        gather.embedding_gather_bwd(torch.zeros((3, 4), dtype=torch.float16,
                                                device=cuda_device),
                                    np.arange(3), 10)
    assert counts == (ssd.KERNEL_LAUNCHES, gather.KERNEL_LAUNCHES,
                      gather.BWD_LAUNCHES)
