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

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as ref_ops
from repro.kernels import sell_core as ref_sell_core
from repro.kernels.execspec import ExecSpec as RefExecSpec
from repro.sparse import formats as RF
from repro_torch.analysis import LaunchPlanError, SlabMeta
from repro_torch.analysis.preflight import plan_spmm_sell_stream
from repro_torch.core.autotune import (
    MAX_K_TILE,
    SMEM_PER_BLOCK,
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
