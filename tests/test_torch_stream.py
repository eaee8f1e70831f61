"""Parity of the port's streaming SpMM schedule (kernel B2's plain version,
``repro_torch.kernels.sell_core.spmm_sell_stream`` on the CPU) with the
reference's ``repro.kernels.sell_core.spmm_sell_stream`` in Pallas
interpret mode, plus its tiles, its launch plan and its ``ops`` dispatch.

Both packages see the same numpy-seeded operands.  Tolerance 1e-10 at fp64
(the reference's own, ``tests/test_stream.py``); on rows whose columns
ascend the plain B2 is bit-equal to the plain B1, since the column tiles
only reorder exact zeros.
"""
import dataclasses
import types

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as ref_ops
from repro.kernels import sell_core as ref_sell_core
from repro.kernels.execspec import ExecSpec as RefExecSpec
from repro.sparse import formats as RF
from repro_torch.analysis import LaunchPlanError, SlabMeta
from repro_torch.analysis.preflight import (
    StreamMapMeta,
    plan_spmm_sell_stream,
    stream_block_rows,
    stream_bucket_rows,
    stream_chunk_rows,
)
from repro_torch.core.autotune import (
    MAX_K_TILE,
    SMEM_PER_BLOCK,
    STREAM_FILL_BLOCKS,
    pick_stream_tiles,
    stream_smem_bytes,
    tune_sell_layout,
)
from repro_torch.kernels import ops, sell_core
from repro_torch.kernels.execspec import ExecSpec
from repro_torch.sparse import formats as F

TOL = dict(rtol=1e-10, atol=1e-10)
CPU = ExecSpec(device="cpu")


def _port_csr(ref):
    return F.CSRMatrix(indptr=ref.indptr, indices=ref.indices, data=ref.data,
                       n_cols=ref.n_cols)


def _ref_args(slabs):
    return tuple(tuple(jnp.asarray(a) for a in arrays) for arrays in
                 (slabs.bucket_cols, slabs.bucket_vals, slabs.bucket_rows))


def _both_stream(ref_csr, x, *, c, sigma, w_block, k_block, col_tile,
                 row_tile):
    """(reference streamed, port streamed, port resident) on one operand."""
    ref_slabs = RF.csr_to_sell_slabs(ref_csr, c=c, sigma=sigma)
    want = np.asarray(ref_sell_core.spmm_sell_stream(
        *_ref_args(ref_slabs), jnp.asarray(x), n_rows=ref_csr.n_rows,
        w_block=w_block, k_block=k_block, col_tile=col_tile,
        row_tile=row_tile, interpret=True))
    cols, vals, rows = F.csr_to_sell_slabs(
        _port_csr(ref_csr), c=c, sigma=sigma).to_device("cpu")
    xt = torch.from_numpy(x)
    got = sell_core.spmm_sell_stream(cols, vals, rows, xt,
                                     n_rows=ref_csr.n_rows, k_block=k_block,
                                     col_tile=col_tile, row_tile=row_tile)
    resident = sell_core.spmm_sell(cols, vals, rows, xt,
                                   n_rows=ref_csr.n_rows, k_block=k_block)
    return want, got, resident


# ---------------------------------------------------------------------------
# The plain B2 against the reference's streaming schedule
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c,sigma_factor,w_block", [(4, 1, 4), (16, 4, 8),
                                                    (32, 8, 8)])
@pytest.mark.parametrize("k,k_block,col_tile", [(1, 1, 32), (3, 2, 64),
                                                (5, 8, 16), (8, 4, 128)])
def test_stream_matches_reference_grid(c, sigma_factor, w_block, k, k_block,
                                       col_tile):
    # 101 columns is prime: no col_tile of the grid divides it
    ref = RF.random_csr(75, 101, 5.0, seed=c * 100 + k, skew=1.0)
    x = np.random.default_rng(k).standard_normal((101, k))
    want, got, resident = _both_stream(
        ref, x, c=c, sigma=sigma_factor * c, w_block=w_block,
        k_block=k_block, col_tile=col_tile, row_tile=2)
    assert tuple(got.shape) == (75, k) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    assert torch.equal(got, resident)


def test_stream_prime_cols_and_non_pow2_row_tile():
    """61 columns, col_tile 16 (4 ragged tiles), row_tile 3 (does not
    divide the slice count)."""
    ref = RF.random_csr(64, 61, 4.0, seed=5, skew=1.1)
    x = np.random.default_rng(17).standard_normal((61, 3))
    want, got, resident = _both_stream(ref, x, c=8, sigma=32, w_block=4,
                                       k_block=2, col_tile=16, row_tile=3)
    np.testing.assert_allclose(got.numpy(), want, **TOL)
    np.testing.assert_allclose(got.numpy(), RF.csr_to_dense(ref) @ x, **TOL)
    assert torch.equal(got, resident)


@pytest.mark.parametrize("empty", [False, True])
def test_stream_empty_rows_and_all_empty(empty):
    dense = np.zeros((6, 5))
    if not empty:
        dense[0, 1] = 2.0
        dense[3, [0, 2, 4]] = [1.0, -1.5, 3.0]   # rows 1, 2, 4, 5 empty
    ref = RF.csr_from_dense(dense)
    x = np.random.default_rng(3).standard_normal((5, 3))
    want, got, resident = _both_stream(ref, x, c=4, sigma=8, w_block=8,
                                       k_block=2, col_tile=4, row_tile=2)
    np.testing.assert_allclose(got.numpy(), want, atol=1e-10)
    np.testing.assert_allclose(got.numpy(), dense @ x, atol=1e-10)
    assert torch.equal(got, resident)


def _shuffled_rows(csr: F.CSRMatrix, seed: int) -> F.CSRMatrix:
    """The same matrix with each row's entries in a random order."""
    rng = np.random.default_rng(seed)
    indices, data = csr.indices.copy(), csr.data.copy()
    for lo, hi in zip(csr.indptr[:-1], csr.indptr[1:]):
        p = lo + rng.permutation(hi - lo)
        indices[lo:hi], data[lo:hi] = indices[p], data[p]
    return F.CSRMatrix(indptr=csr.indptr, indices=indices, data=data,
                       n_cols=csr.n_cols)


def _pad_first(slabs: F.SellSlabs) -> F.SellSlabs:
    """The same slabs with each row's w axis rotated by one: a row's last
    slot (PAD where the row is shorter than its bucket) comes first."""
    return dataclasses.replace(
        slabs,
        bucket_cols=tuple(np.roll(c, 1, axis=1) for c in slabs.bucket_cols),
        bucket_vals=tuple(np.roll(v, 1, axis=1) for v in slabs.bucket_vals))


def test_unsorted_rows_and_inner_pad_run_as_packed_and_agree_to_rounding():
    """Rows whose columns do not ascend, and rows with PAD before their
    entries: ``ops`` streams the packed slabs as they are, from the very
    tensors B1 reads (one upload per operand), and the plain B2 agrees with
    the plain B1 and with the reference's streaming schedule at 1e-10 (it
    adds a row's entries tile by tile, so the order of additions differs
    from B1's)."""
    csr = _shuffled_rows(F.random_csr(120, 90, 6.0, seed=4, skew=1.0), 9)
    slabs = F.csr_to_sell_slabs(csr, c=16, sigma=32)
    keys = [np.where(c == F.PAD, np.iinfo(np.int64).max, c.astype(np.int64))
            for c in slabs.bucket_cols]
    assert not all((np.diff(k, axis=1) >= 0).all() for k in keys)
    x = np.random.default_rng(5).standard_normal((90, 4))
    want = np.stack([csr.matvec(x[:, j]) for j in range(4)], axis=1)
    pad_first = _pad_first(slabs)
    assert any((c[:, 0] == F.PAD).any() for c in pad_first.bucket_cols)
    spec = dataclasses.replace(CPU, vl=16)
    for operand in (slabs, pad_first):
        resident = ops.spmm(operand, x, spec=spec)
        streamed = ops.spmm(operand, x, spec=dataclasses.replace(
            spec, mode="stream", col_tile=8))
        assert set(ops._PREPARED[id(operand)]) == {"meta", torch.device("cpu")}
        ref = np.asarray(ref_sell_core.spmm_sell_stream(
            *_ref_args(operand), jnp.asarray(x), n_rows=120, w_block=8,
            k_block=4, col_tile=8, row_tile=2, interpret=True))
        np.testing.assert_allclose(streamed.numpy(), ref, **TOL)
        np.testing.assert_allclose(streamed.numpy(), resident.numpy(), **TOL)
        np.testing.assert_allclose(streamed.numpy(), want, **TOL)
        np.testing.assert_allclose(resident.numpy(), want, **TOL)


# ---------------------------------------------------------------------------
# Tiles, plan and tuner on the Hopper budget
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("itemsize", [4, 8])
def test_pick_stream_tiles_fills_one_blocks_shared_memory(itemsize):
    k_tile = 1
    while k_tile <= MAX_K_TILE:
        for c in (8, 32, 256, 1024):
            ct, rt = pick_stream_tiles(c, k_tile, itemsize)
            assert ct & (ct - 1) == 0
            assert stream_smem_bytes(ct, k_tile, itemsize) <= SMEM_PER_BLOCK
            assert stream_smem_bytes(2 * ct, k_tile, itemsize) > SMEM_PER_BLOCK
            assert rt == max(1, 256 // c)
        k_tile *= 2
    if itemsize == 8:
        assert pick_stream_tiles(32, 1, 8)[0] == 8192
        assert pick_stream_tiles(32, 32, 8)[0] == 256


def test_tuner_fills_the_stream_tiles():
    lengths = np.random.default_rng(1).poisson(6, 4096).clip(1)
    tuned = tune_sell_layout(lengths)
    assert (tuned.col_tile, tuned.row_tile) == \
        pick_stream_tiles(tuned.c, tuned.k_block)


def _meta(n_rows, n_cols, c=8, width=8, n_slices=4):
    return SlabMeta(kind="matrix", c=c, widths=(width,),
                    n_slices=(n_slices,), n_rows=n_rows, n_cols=n_cols,
                    val_dtype="float64", idx_dtype="int32")


def test_stream_plan_accepts_a_giant_operand_and_rejects_oversized_tiles():
    giant = _meta(1 << 20, 1 << 20, c=512, n_slices=1 << 11)
    ct, rt = pick_stream_tiles(512, 8)
    plan = plan_spmm_sell_stream(giant, k=8, x_dtype="float64", k_block=8,
                                 col_tile=ct, row_tile=rt)
    plan.raise_if_invalid()
    assert plan.blocks[0].smem_bytes == stream_smem_bytes(ct, 8, 8)
    assert plan.blocks[0].block == (256,)
    assert plan.blocks[0].grid == ((1 << 11) * 512 // 256, 1)
    meta = _meta(64, 1 << 20)
    bad = plan_spmm_sell_stream(meta, k=8, x_dtype="float64",
                                col_tile=1 << 24, row_tile=8)
    assert not bad.ok and any("shared memory" in v for v in bad.violations)
    with pytest.raises(LaunchPlanError):
        bad.raise_if_invalid()
    for ct, rt in ((0, 1), (64, 0)):
        assert not plan_spmm_sell_stream(meta, k=8, col_tile=ct,
                                         row_tile=rt).ok
    # col_tile is clamped at pow2_ceil(n_cols), as the wrapper clamps it,
    # and a non-pow2 row_tile gives blocks of row_tile slices
    small = _meta(40, 100, c=8, n_slices=5)
    plan = plan_spmm_sell_stream(small, k=1, x_dtype="float64", k_block=1,
                                 col_tile=1 << 20, row_tile=3)
    assert plan.ok and plan.blocks[0].smem_bytes == stream_smem_bytes(128, 1, 8)
    assert plan.blocks[0].block == (32,) and plan.blocks[0].grid == (2, 1)


def test_ops_refuses_an_oversized_col_tile_before_any_launch():
    csr = F.random_csr(64, 5000, 3.0, seed=2)
    spec = dataclasses.replace(CPU, vl=8, mode="stream", col_tile=1 << 16)
    before = sell_core.STREAM_LAUNCHES
    with pytest.raises(LaunchPlanError, match="shared memory"):
        ops.spmm(csr, np.ones((5000, 8)), spec=spec)
    assert sell_core.STREAM_LAUNCHES == before


# ---------------------------------------------------------------------------
# ops dispatch
# ---------------------------------------------------------------------------


def test_ops_mode_dispatch_matches_reference():
    ref = RF.random_csr(96, 96, 5.0, seed=2, skew=1.0)
    port = _port_csr(ref)
    x = np.random.default_rng(17).standard_normal((96, 4))
    spec = dataclasses.replace(CPU, vl=16)
    ref_slabs = RF.csr_to_sell_slabs(ref, c=16, sigma=64)
    slabs = F.csr_to_sell_slabs(port, c=16, sigma=64)
    auto = ops.spmm(slabs, x, spec=spec)
    res = ops.spmm(slabs, x, spec=dataclasses.replace(spec, mode="resident"))
    stream = ops.spmm(slabs, x, spec=dataclasses.replace(spec, mode="stream"))
    assert torch.equal(auto, res) and torch.equal(stream, res)
    want = np.asarray(ref_ops.spmm(ref_slabs, x, spec=RefExecSpec(
        vl=16, mode="stream", interpret=True)))
    np.testing.assert_allclose(stream.numpy(), want, **TOL)
    # the spec's tiles reach the schedule; no tile changes the result
    tiled = ops.spmm(slabs, x, spec=dataclasses.replace(
        spec, mode="stream", col_tile=8, row_tile=3))
    assert torch.equal(tiled, res)
    # spmv runs its k = 1 column through the same branch
    y = ops.spmv(slabs, x[:, 0], spec=dataclasses.replace(spec, mode="stream"))
    assert torch.equal(y, res[:, 0])
    with pytest.raises(ValueError, match="mode"):
        ops.spmm(slabs, x, spec=dataclasses.replace(spec, mode="turbo"))
    ell = F.csr_to_ellpack(port, c=16)
    with pytest.raises(ValueError, match="SELL"):
        ops.spmm(ell, x, spec=dataclasses.replace(spec, mode="stream"))


def test_auto_runs_the_resident_kernel_where_the_reference_streams(
        monkeypatch):
    """The reference's ``auto`` streams an operand whose X outgrows VMEM
    (600,000 columns at k = 8, its ``tests/test_stream.py``); on Hopper B1
    keeps nothing resident and B2 was slower on every measured shape, so
    the port's ``auto`` runs B1 on that operand as on a small one."""
    def refuse(*args, **kwargs):
        raise AssertionError("auto took the streaming schedule")

    monkeypatch.setattr(sell_core, "spmm_sell_stream", refuse)
    rng = np.random.default_rng(11)
    for n_cols in (96, 600_000):
        csr = F.random_csr(64, n_cols, 2.0, seed=11)
        x = rng.standard_normal((n_cols, 8))
        got = ops.spmm(csr, x, spec=dataclasses.replace(CPU, vl=32))
        want = np.stack([csr.matvec(x[:, j]) for j in range(8)], axis=1)
        np.testing.assert_allclose(got.numpy(), want, **TOL)


# ---------------------------------------------------------------------------
# Kernel B2's block column map and a plain model of its chunk walk
# ---------------------------------------------------------------------------


def _map_operands():
    """A cage10-like operand, a rectangular giant-like one (few entries a
    row over many columns), and cage10 with its rows out of column order
    and with PAD before their entries."""
    cage = F.cage10_like(seed=0)
    shuffled = F.csr_to_sell_slabs(_shuffled_rows(cage, 5), c=32)
    return {
        "cage10": F.csr_to_sell_slabs(cage, c=256),
        "giant_like": F.csr_to_sell_slabs(
            F.random_csr(1024, 300_000, 2.0, seed=3), c=256),
        "shuffled": shuffled,
        "pad_first": _pad_first(shuffled),
    }


def _block_rows(slabs, row_tile=None, k_tile=8):
    rt = row_tile or pick_stream_tiles(slabs.c, k_tile)[1]
    return stream_bucket_rows(rt, [c.shape for c in slabs.bucket_cols])


@pytest.mark.parametrize("name", ["cage10", "giant_like", "shuffled",
                                  "pad_first"])
def test_column_map_lists_every_blocks_columns_once_in_order(name):
    slabs = _map_operands()[name]
    block_rows = _block_rows(slabs)
    smap = F.stream_column_map(slabs.bucket_cols, block_rows)
    distinct = 0
    for cols, ptr, lst, lcols, end, rb in zip(
            slabs.bucket_cols, smap.block_ptr, smap.block_cols, smap.lcols,
            smap.lane_end, smap.block_rows):
        s, w, c = cols.shape
        assert lcols.shape == cols.shape and lcols.dtype == np.int32
        assert ptr.dtype == np.int64 and lst.dtype == np.int32
        assert len(ptr) == -(-s * c // rb) + 1
        lane = np.arange(s * c).reshape(s, c)
        for b in range(len(ptr) - 1):
            seg = lst[ptr[b]:ptr[b + 1]]
            mine = cols.transpose(0, 2, 1).reshape(s * c, w)[b * rb:(b + 1) * rb]
            want = np.unique(mine[mine != F.PAD])
            np.testing.assert_array_equal(seg, want)    # ascending, distinct
            distinct += len(want)
        real = cols != F.PAD
        block = np.broadcast_to((lane // rb)[:, None, :], cols.shape)
        np.testing.assert_array_equal(lst[ptr[block[real]] + lcols[real]],
                                      cols[real])
        assert (lcols[~real] == F.PAD).all()
        # each lane's walk ends one past its last real slot
        last = np.array([[max([i + 1 for i in range(w) if cols[a, i, b]
                               != F.PAD], default=0) for b in range(c)]
                         for a in range(s)])
        np.testing.assert_array_equal(end, last)
    assert smap.x_rows == distinct
    assert smap.longest == tuple(int(np.diff(p).max()) for p in smap.block_ptr)
    # the schedule's X bytes at fp64 and k_tile 8: one staged row of the
    # k tile for each (block, distinct column) pair
    assert smap.x_rows * 8 * 8 == distinct * 64
    if name == "pad_first":
        assert any((c[:, 0] == F.PAD).any() for c in slabs.bucket_cols)


def _chunk_walk(bucket_cols, bucket_vals, bucket_rows, x, n_rows, smap,
                chunk_rows):
    """Kernel B2's walk in plain PyTorch, thread by thread in step: per
    block, each row's cursor over its lane's w axis (ending at lane_end,
    skipping PAD), the next chunk the one holding the block-wide minimum of
    the cursors' local indices, its X rows staged from the block's list,
    and every row consuming, in w order, its entries in that chunk (one
    multiply and one add each, as the plain B1).  Returns Y and the X rows
    staged."""
    y = torch.zeros((n_rows + 1, x.shape[1]), dtype=x.dtype)
    staged = 0
    end_mark = np.iinfo(np.int64).max
    for cols, vals, rows, ptr, lst, lcols, ends, rb in zip(
            bucket_cols, bucket_vals, bucket_rows, smap.block_ptr,
            smap.block_cols, smap.lcols, smap.lane_end, smap.block_rows):
        s, w, c = cols.shape
        lc = torch.from_numpy(lcols).permute(0, 2, 1).reshape(s * c, w)
        vl = vals.permute(0, 2, 1).reshape(s * c, w)
        ends = torch.from_numpy(ends).reshape(-1).long()
        rows = rows.reshape(-1).long()
        for b in range(len(ptr) - 1):
            lanes = torch.arange(b * rb, min((b + 1) * rb, s * c))
            lst_b = torch.from_numpy(lst[ptr[b]:ptr[b + 1]]).long()
            cur = torch.zeros(len(lanes), dtype=torch.long)
            acc = torch.zeros((len(lanes), x.shape[1]), dtype=x.dtype)

            def nxt():
                """Each cursor moved past PAD; its local index, or END."""
                while True:
                    inside = cur < ends[lanes]
                    at = lc[lanes, cur.clamp(max=w - 1)]
                    out = torch.where(inside, at.long(), end_mark)
                    pad = inside & (at == F.PAD)
                    if not bool(pad.any()):
                        return out
                    cur[pad] += 1

            nc = nxt()
            while int(nc.min()) != end_mark:
                lo = int(nc.min()) // chunk_rows * chunk_rows
                hi = min(lo + chunk_rows, len(lst_b))
                buf = x[lst_b[lo:hi]]
                staged += hi - lo
                while True:
                    take = (nc >= lo) & (nc < hi)
                    if not bool(take.any()):
                        break
                    i = torch.nonzero(take).reshape(-1)
                    t = lanes[i]
                    acc[i] += vl[t, cur[i]][:, None] * buf[nc[i] - lo]
                    cur[i] += 1
                    nc = nxt()
            y[rows[lanes]] = acc
    return y[:n_rows], staged


def _model_operands():
    """Smaller operands of the same kinds for the walk model (the
    reference's interpret mode runs at a few hundred rows a second)."""
    cage = F.random_csr(1500, 1500, 8.0, seed=4, skew=1.2)
    shuffled = F.csr_to_sell_slabs(_shuffled_rows(cage, 5), c=32)
    return {
        "cage10": F.csr_to_sell_slabs(F.cage10_like(seed=0), c=256),
        "giant_like": F.csr_to_sell_slabs(
            F.random_csr(1024, 300_000, 2.0, seed=3), c=256),
        "shuffled": shuffled,
        "pad_first": _pad_first(shuffled),
    }


@pytest.mark.parametrize("name,chunk_rows", [
    ("cage10", 64), ("cage10", 4096), ("giant_like", 16),
    ("shuffled", 64), ("pad_first", 64)])
def test_chunk_walk_model_holds_to_b1_and_both_stream_references(
        name, chunk_rows):
    """The model of B2's walk is bit-equal to the plain B1 (rows out of
    column order and PAD first included), within 1e-10 of the plain B2 and
    of the reference's streaming schedule (interpret mode), and stages
    each (block, column) pair once where rows ascend."""
    slabs = _model_operands()[name]
    block_rows = _block_rows(slabs)
    smap = F.stream_column_map(slabs.bucket_cols, block_rows)
    cols, vals, rows = slabs.to_device("cpu")
    x = torch.from_numpy(np.random.default_rng(7).standard_normal(
        (slabs.n_cols, 3)))
    got, staged = _chunk_walk(cols, vals, rows, x, slabs.n_rows, smap,
                              chunk_rows)
    b1 = sell_core.spmm_sell_ref(cols, vals, rows, x, n_rows=slabs.n_rows)
    assert torch.equal(got, b1)
    plain = sell_core.spmm_sell_stream_ref(cols, vals, rows, x,
                                           n_rows=slabs.n_rows,
                                           col_tile=chunk_rows)
    torch.testing.assert_close(got, plain, rtol=1e-10, atol=1e-10)
    if name in ("cage10", "giant_like"):
        assert staged == smap.x_rows
        multi = any(int(np.diff(p).max()) > chunk_rows for p in smap.block_ptr)
        assert multi == (chunk_rows < max(smap.longest))
    else:
        assert staged >= smap.x_rows
    if name != "cage10":     # interpret mode is slow on cage10's 11,397 rows
        ref = np.asarray(ref_sell_core.spmm_sell_stream(
            *_ref_args(slabs), jnp.asarray(x.numpy()), n_rows=slabs.n_rows,
            w_block=8, k_block=4, col_tile=chunk_rows, row_tile=1,
            interpret=True))
        np.testing.assert_allclose(got.numpy(), ref, **TOL)


def _some_buckets(slabs: F.SellSlabs, keep: slice) -> F.SellSlabs:
    """``slabs`` with only the buckets ``keep`` names, adopted through
    :func:`F.slabs_from_arrays`: the rows of the other buckets are named
    by no bucket."""
    cols, vals, rows = (a[keep] for a in (slabs.bucket_cols,
                                          slabs.bucket_vals,
                                          slabs.bucket_rows))
    return F.slabs_from_arrays(types.SimpleNamespace(
        bucket_cols=cols, bucket_vals=vals, bucket_rows=rows,
        n_rows=slabs.n_rows, n_cols=slabs.n_cols,
        nnz=sum(int((c != F.PAD).sum()) for c in cols), sigma=slabs.sigma))


def test_rows_no_bucket_names_read_zero_on_the_streaming_schedule():
    """Slabs adopted through slabs_from_arrays need not name every row
    (here the first bucket is left out).  Such rows read 0 from the plain
    B2, from the model of its walk (which allocates Y as the wrapper does)
    and from ``ops`` in stream mode, as from the plain B1 and the
    reference's streaming schedule; the other rows keep their values."""
    full = F.csr_to_sell_slabs(F.random_csr(300, 400, 6.0, seed=11,
                                            skew=1.2), c=8)
    assert full.n_buckets >= 2
    sub = _some_buckets(full, slice(1, None))
    named = np.unique(np.concatenate([r.ravel() for r in sub.bucket_rows]))
    unnamed = np.setdiff1d(np.arange(sub.n_rows), named)
    assert unnamed.size
    cols, vals, rows = sub.to_device("cpu")
    x = torch.from_numpy(np.random.default_rng(3).standard_normal((400, 3)))
    b1 = sell_core.spmm_sell_ref(cols, vals, rows, x, n_rows=sub.n_rows)
    plain = sell_core.spmm_sell_stream(cols, vals, rows, x,
                                       n_rows=sub.n_rows, col_tile=64)
    smap = F.stream_column_map(sub.bucket_cols, _block_rows(sub))
    model, _ = _chunk_walk(cols, vals, rows, x, sub.n_rows, smap, 64)
    via_ops = ops.spmm(sub, x.numpy(), spec=dataclasses.replace(
        CPU, mode="stream"))
    ref = np.asarray(ref_sell_core.spmm_sell_stream(
        *_ref_args(sub), jnp.asarray(x.numpy()), n_rows=sub.n_rows,
        w_block=8, k_block=4, col_tile=64, row_tile=1, interpret=True))
    whole = sell_core.spmm_sell_ref(*full.to_device("cpu"), x,
                                    n_rows=full.n_rows)
    for y in (b1, plain, model, torch.as_tensor(via_ops), torch.tensor(ref)):
        assert not y[unnamed].any()
        torch.testing.assert_close(y[named[named < sub.n_rows]],
                                   whole[named[named < sub.n_rows]], **TOL)
    assert torch.equal(model, b1)


def test_block_rows_shrink_to_fill_the_card():
    """A block holds row_tile slices (at most 256 rows), cut in whole warps
    down to one while the bucket gives fewer than two blocks an SM."""
    assert STREAM_FILL_BLOCKS == 2 * 132
    # the 2,097,152-row operand at C = 32: 8 slices a block, thousands of
    # blocks in its big buckets, smaller blocks in its two widest
    assert stream_block_rows(8, 32, 16_712 * 32) == 256
    assert stream_block_rows(8, 32, 2 * 32) == 32
    assert stream_block_rows(8, 32, 663 * 32) == 64      # 332 blocks
    # the 8,192-row giant operand at C = 256: one slice a block would be
    # 32 blocks; one warp a block gives 256
    assert stream_block_rows(1, 256, 8192) == 32
    for rows in (32, 64, 128, 256, 8192, 1 << 20):
        got = stream_block_rows(8, 32, rows)
        assert got % 32 == 0 and 32 <= got <= 256
        assert got == 32 or -(-rows // got) >= STREAM_FILL_BLOCKS
        assert got == 256 or -(-rows // (2 * got)) < STREAM_FILL_BLOCKS
    # below a warp (row_tile 3 of C = 8) nothing is cut
    assert stream_block_rows(3, 8, 40) == 24


def test_ops_builds_the_column_map_once_per_operand(monkeypatch):
    slabs = F.csr_to_sell_slabs(F.random_csr(300, 5000, 4.0, seed=1), c=32)
    ops._prepared(slabs, torch.device("cpu"))
    built = []
    real = ops.stream_column_map
    monkeypatch.setattr(ops, "stream_column_map",
                        lambda *a: built.append(1) or real(*a))
    rows = _block_rows(slabs)
    meta1, map1 = ops._stream_map(slabs, rows, torch.device("cpu"))
    meta2, map2 = ops._stream_map(slabs, rows, torch.device("cpu"))
    assert built == [1] and map1 is map2 and meta1 is meta2
    assert all(isinstance(t, torch.Tensor) for t in map1.lcols)
    assert meta1.block_rows == rows and sum(meta1.listed) == map1.x_rows
    sell_core._check_column_map(map1, tuple(
        torch.from_numpy(c) for c in slabs.bucket_cols), rows,
        torch.device("cpu"))
    with pytest.raises(ValueError, match="block rows"):
        sell_core._check_column_map(map1, tuple(
            torch.from_numpy(c) for c in slabs.bucket_cols),
            tuple(r * 2 for r in rows), torch.device("cpu"))
    ops._stream_map(slabs, tuple(64 for _ in rows), torch.device("cpu"))
    assert built == [1, 1]


def test_stream_plan_holds_the_column_map_to_the_slabs():
    slabs = F.csr_to_sell_slabs(F.random_csr(300, 5000, 4.0, seed=1), c=32)
    meta = SlabMeta.from_slabs(slabs, check_bounds=True)
    ct, rt = pick_stream_tiles(32, 8)
    rows = stream_bucket_rows(rt, [c.shape for c in slabs.bucket_cols])
    smap = F.stream_column_map(slabs.bucket_cols, rows)
    good = StreamMapMeta.from_map(smap)
    assert good.local_excess < 0 and good.col_max < 5000
    plan = plan_spmm_sell_stream(meta, k=8, x_dtype="float64", k_block=8,
                                 col_tile=ct, row_tile=rt, column_map=good)
    plan.raise_if_invalid()
    for b, longest, r in zip(plan.blocks, smap.longest, rows):
        chunk = stream_chunk_rows(ct, longest)
        assert chunk == min(ct, longest)
        assert b.smem_bytes == stream_smem_bytes(chunk, 8, 8)
        assert b.block == (r,)
    # a local index past its block's list, a listed column past n_cols,
    # another block size: refused before any launch
    lcols = list(smap.lcols)
    lcols[-1] = np.where(lcols[-1] == F.PAD, F.PAD, lcols[-1] + 10_000)
    bad = StreamMapMeta.from_map(dataclasses.replace(smap, lcols=tuple(lcols)))
    with pytest.raises(LaunchPlanError, match="local index"):
        plan_spmm_sell_stream(meta, k=8, col_tile=ct, row_tile=rt,
                              column_map=bad).raise_if_invalid()
    lists = list(smap.block_cols)
    lists[0] = lists[0] + 5000
    bad = StreamMapMeta.from_map(dataclasses.replace(
        smap, block_cols=tuple(lists)))
    with pytest.raises(LaunchPlanError, match="out of bounds for n_cols"):
        plan_spmm_sell_stream(meta, k=8, col_tile=ct, row_tile=rt,
                              column_map=bad).raise_if_invalid()
    other = dataclasses.replace(good, block_rows=tuple(
        2 * r for r in good.block_rows))
    with pytest.raises(LaunchPlanError, match="block rows"):
        plan_spmm_sell_stream(meta, k=8, col_tile=ct, row_tile=rt,
                              column_map=other).raise_if_invalid()


def test_column_map_refuses_arrays_that_disagree():
    """A map is checked once when it is made (a launch then only matches
    it to its slabs): dtypes, contiguity, lane_end and block_ptr sizes."""
    slabs = F.csr_to_sell_slabs(F.random_csr(200, 3000, 3.0, seed=6), c=16)
    rows = _block_rows(slabs)
    smap = F.stream_column_map(slabs.bucket_cols, rows)
    on_cpu = smap.to_device("cpu")
    assert on_cpu.device == torch.device("cpu") and smap.device is None
    assert on_cpu.longest == smap.longest
    bad = [
        dict(block_ptr=tuple(p.astype(np.int32) for p in smap.block_ptr)),
        dict(lcols=smap.lcols[:-1] + (smap.lcols[-1][:, ::-1, :],)),
        dict(lane_end=tuple(e[:, :-1] for e in smap.lane_end)),
        dict(block_rows=tuple(2 * r for r in smap.block_rows)),
        dict(longest=smap.longest[:-1]),
    ]
    for change in bad:
        with pytest.raises(ValueError, match="column map"):
            dataclasses.replace(smap, **change)
    assert slabs.bucket_cols[-1].shape[1] > 1
    with pytest.raises(ValueError, match="column map arrays on"):
        dataclasses.replace(on_cpu, lcols=tuple(
            c.to("meta") for c in on_cpu.lcols))
