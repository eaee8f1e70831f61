"""Parity of the port's SELL core (``repro_torch.kernels.sell_core``) and host
packing (``repro_torch.sparse.formats``) with the JAX reference.

The same numpy-seeded inputs go through both packages: the reference's
Pallas kernel runs in interpret mode (as ``tests/test_sell_core.py`` runs
it), the port's wrapper takes its plain PyTorch path because the tensors
lie on the CPU.  Tolerance 1e-10 at fp64 (the reference's own).  The CUDA
kernel itself is tested on the card by ``tests/test_torch_cuda.py``.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import sell as ref_sell
from repro.kernels import sell_core as ref_core
from repro.sparse import formats as RF
from repro_torch.kernels import cuda_lib
from repro_torch.kernels import sell_core
from repro_torch.sparse import formats as F

TOL = 1e-10


def _ref_args(slabs):
    return (tuple(jnp.asarray(c) for c in slabs.bucket_cols),
            tuple(jnp.asarray(v) for v in slabs.bucket_vals),
            tuple(jnp.asarray(r) for r in slabs.bucket_rows))


def _port_slabs(ref_slabs):
    return F.slabs_from_arrays(ref_slabs)


def _both(csr_ref, x, *, c, sigma, k_block):
    """Reference interpret-mode kernel and port plain path on one input."""
    slabs = RF.csr_to_sell_slabs(csr_ref, c=c, sigma=sigma)
    want = np.asarray(ref_core.spmm_sell(
        *_ref_args(slabs), jnp.asarray(x), n_rows=csr_ref.n_rows, w_block=8,
        k_block=k_block, interpret=True))
    cols, vals, rows = _port_slabs(slabs).to_device("cpu")
    got = sell_core.spmm_sell(cols, vals, rows,
                              torch.from_numpy(x), n_rows=csr_ref.n_rows,
                              k_block=k_block)
    return got.numpy(), want


# ---------------------------------------------------------------------------
# Copied helpers
# ---------------------------------------------------------------------------


def test_padding_helpers_match_reference():
    for k in range(0, 70):
        assert F.pow2_ceil(k) == RF.pow2_ceil(k)
        for kb in (1, 2, 4, 8, 16, 32, 64):
            assert sell_core.k_tile_for(k, kb) == ref_core.k_tile_for(k, kb)
            assert sell_core.padded_k(k, kb) == ref_core.padded_k(k, kb)
    xs = np.arange(0, 3000)
    np.testing.assert_array_equal(F.next_pow2(xs), RF.next_pow2(xs))
    assert sell_core.PAD == ref_core.PAD == F.PAD == RF.PAD


# ---------------------------------------------------------------------------
# Host packing: byte-identical to the reference
# ---------------------------------------------------------------------------


def _empty_rows_dense():
    dense = np.zeros((6, 5))
    dense[0, 1] = 2.0
    dense[3, [0, 2, 4]] = [1.0, -1.5, 3.0]    # rows 1, 2, 4, 5 empty
    return dense


PACK_CASES = [
    ("uniform", lambda: RF.random_csr(300, 310, 5.0, seed=1), 16, None),
    ("skewed", lambda: RF.random_csr(500, 500, 6.0, seed=2, skew=1.5), 32, 128),
    ("cage10", lambda: RF.cage10_like(seed=0), 32, 1024),
    ("empty-rows", lambda: RF.csr_from_dense(_empty_rows_dense()), 4, 8),
    ("all-empty", lambda: RF.csr_from_dense(np.zeros((6, 5))), 4, 8),
    ("single-slice", lambda: RF.random_csr(5, 97, 3.0, seed=4), 8, 8),
    ("fp32", lambda: RF.random_csr(200, 200, 4.0, seed=5, dtype=np.float32),
     32, 64),
]


def _port_csr(csr):
    return F.CSRMatrix(indptr=csr.indptr, indices=csr.indices, data=csr.data,
                       n_cols=csr.n_cols)


def _assert_same_slabs(a, b):
    assert (a.n_rows, a.n_cols, a.nnz, a.sigma) == \
        (b.n_rows, b.n_cols, b.nnz, b.sigma)
    assert len(a.bucket_cols) == len(b.bucket_cols)
    for field in ("bucket_cols", "bucket_vals", "bucket_rows"):
        for x, y in zip(getattr(a, field), getattr(b, field)):
            assert x.dtype == y.dtype and x.shape == y.shape
            assert x.tobytes() == y.tobytes()


@pytest.mark.parametrize("name,make,c,sigma", PACK_CASES,
                         ids=[p[0] for p in PACK_CASES])
def test_packer_is_byte_identical_to_reference(name, make, c, sigma):
    ref = make()
    port = _port_csr(ref)
    _assert_same_slabs(F.csr_to_sell_slabs(port, c=c, sigma=sigma),
                       RF.csr_to_sell_slabs(ref, c=c, sigma=sigma))
    ref_sell_m = RF.csr_to_sell(ref, c=c, sigma=sigma)
    port_sell_m = F.csr_to_sell(port, c=c, sigma=sigma)
    np.testing.assert_array_equal(port_sell_m.perm, ref_sell_m.perm)
    for a, b in zip(port_sell_m.slice_cols, ref_sell_m.slice_cols):
        assert a.tobytes() == b.tobytes()
    _assert_same_slabs(F.sell_to_slabs(port_sell_m),
                       RF.sell_to_slabs(ref_sell_m))
    back = F.to_csr(F.csr_to_sell_slabs(port, c=c, sigma=sigma))
    want = RF.to_csr(RF.csr_to_sell_slabs(ref, c=c, sigma=sigma))
    for field in ("indptr", "indices", "data"):
        assert getattr(back, field).tobytes() == getattr(want, field).tobytes()


@pytest.mark.parametrize("seed,skew", [(0, 0.0), (3, 1.2)])
def test_generators_match_reference(seed, skew):
    a = F.random_csr(400, 333, 7.0, seed=seed, skew=skew)
    b = RF.random_csr(400, 333, 7.0, seed=seed, skew=skew)
    for field in ("indptr", "indices", "data"):
        assert getattr(a, field).tobytes() == getattr(b, field).tobytes()
    x = np.random.default_rng(seed).standard_normal(333)
    np.testing.assert_array_equal(a.matvec(x), b.matvec(x))
    ca, cb = F.cage10_like(seed=seed), RF.cage10_like(seed=seed)
    for field in ("indptr", "indices", "data"):
        assert getattr(ca, field).tobytes() == getattr(cb, field).tobytes()


def test_slabs_from_arrays_round_trips_reference_slabs():
    ref = RF.csr_to_sell_slabs(RF.random_csr(120, 90, 5.0, seed=8, skew=1.0),
                               c=16, sigma=64)
    port = F.slabs_from_arrays(ref)
    _assert_same_slabs(port, ref)
    assert isinstance(port, F.SellSlabs)
    assert port.widths == ref.widths and port.pad_factor == ref.pad_factor
    x = np.random.default_rng(0).standard_normal(90)
    np.testing.assert_array_equal(port.matvec(x), ref.matvec(x))
    cols, vals, rows = port.to_device("cpu")
    assert all(t.dtype == torch.int32 for t in (*cols, *rows))
    assert all(t.dtype == torch.float64 for t in vals)
    assert [tuple(t.shape) for t in cols] == [a.shape for a in ref.bucket_cols]


def test_slabs_from_arrays_rejects_a_broken_layout():
    ref = RF.csr_to_sell_slabs(RF.random_csr(40, 40, 4.0, seed=1), c=8)

    class Fields:
        pass

    bad = Fields()
    for f in ("bucket_cols", "bucket_vals", "n_rows", "n_cols", "nnz", "sigma"):
        setattr(bad, f, getattr(ref, f))
    bad.bucket_rows = tuple(r + ref.n_rows for r in ref.bucket_rows)
    with pytest.raises(ValueError, match="row ids outside"):
        F.slabs_from_arrays(bad)
    bad.bucket_rows = tuple(r.astype(np.int64) for r in ref.bucket_rows)
    with pytest.raises(ValueError, match="int32"):
        F.slabs_from_arrays(bad)
    bad.bucket_rows = tuple(r[:, :-1] for r in ref.bucket_rows)
    with pytest.raises(ValueError, match=r"\(S_b, C\)"):
        F.slabs_from_arrays(bad)


# ---------------------------------------------------------------------------
# SpMM: the port's plain path against the reference kernel
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("skew", [0.0, 1.0])
@pytest.mark.parametrize("c,sigma_factor", [(4, 1), (16, 4), (32, 8)])
@pytest.mark.parametrize("k,k_block", [(1, 1), (3, 2), (5, 8), (8, 4)])
def test_spmm_sell_matches_reference_grid(c, sigma_factor, k, k_block, skew):
    csr = RF.random_csr(75, 80, 5.0, seed=c * 100 + k, skew=skew)
    x = np.random.default_rng(k).standard_normal((80, k))
    got, want = _both(csr, x, c=c, sigma=sigma_factor * c, k_block=k_block)
    assert got.shape == want.shape == (75, k)
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got, RF.csr_to_dense(csr) @ x,
                               rtol=TOL, atol=TOL)


@pytest.mark.parametrize("dense", [_empty_rows_dense(), np.zeros((6, 5))],
                         ids=["empty-rows", "all-empty"])
def test_spmm_sell_empty_rows_match_reference(dense):
    csr = RF.csr_from_dense(dense)
    x = np.random.default_rng(3).standard_normal((5, 3))
    got, want = _both(csr, x, c=4, sigma=8, k_block=2)
    np.testing.assert_allclose(got, want, atol=TOL)
    np.testing.assert_allclose(got, dense @ x, atol=TOL)


def test_spmm_sell_single_slice_and_prime_n_cols():
    csr = RF.random_csr(5, 97, 6.0, seed=11, skew=0.8)   # 5 rows < C = 8
    x = np.random.default_rng(2).standard_normal((97, 4))
    got, want = _both(csr, x, c=8, sigma=8, k_block=4)
    assert len(RF.csr_to_sell_slabs(csr, c=8, sigma=8).bucket_cols[0]) == 1
    np.testing.assert_allclose(got, want, rtol=TOL, atol=TOL)


def test_spmv_sell_is_the_k1_column():
    csr = RF.random_csr(64, 64, 6.0, seed=9, skew=1.2)
    slabs = RF.csr_to_sell_slabs(csr, c=16, sigma=64)
    x = np.random.default_rng(4).standard_normal(64)
    cols, vals, rows = _port_slabs(slabs).to_device("cpu")
    xt = torch.from_numpy(x)
    via_spmv = sell_core.spmv_sell(cols, vals, rows, xt, n_rows=64)
    via_spmm = sell_core.spmm_sell(cols, vals, rows, xt[:, None], n_rows=64,
                                   k_block=1)[:, 0]
    torch.testing.assert_close(via_spmv, via_spmm, rtol=0, atol=0)
    want = np.asarray(ref_sell.spmv_sell(*_ref_args(slabs), jnp.asarray(x),
                                         n_rows=64, interpret=True))
    np.testing.assert_allclose(via_spmv.numpy(), want, rtol=TOL, atol=TOL)


def test_spmm_sell_ref_keeps_the_dump_row_contract():
    """Pad lanes scatter into row n_rows of the (n_rows + 1, k) buffer and
    are trimmed: the result has exactly n_rows rows whatever C pads to."""
    csr = F.random_csr(13, 20, 3.0, seed=2)               # 13 rows, C = 8
    slabs = F.csr_to_sell_slabs(csr, c=8)
    assert slabs.n_slices * 8 > 13
    cols, vals, rows = slabs.to_device("cpu")
    x = torch.from_numpy(np.random.default_rng(0).standard_normal((20, 3)))
    y = sell_core.spmm_sell_ref(cols, vals, rows, x, n_rows=13)
    assert tuple(y.shape) == (13, 3)
    want = np.stack([csr.matvec(x.numpy()[:, i]) for i in range(3)], axis=1)
    np.testing.assert_allclose(y.numpy(), want, rtol=TOL, atol=TOL)


# ---------------------------------------------------------------------------
# The wrapper: argument contract and device routing
# ---------------------------------------------------------------------------


def _small_bucket_tensors():
    slabs = F.csr_to_sell_slabs(F.random_csr(30, 30, 4.0, seed=6), c=8)
    cols, vals, rows = slabs.to_device("cpu")
    x = torch.from_numpy(np.random.default_rng(1).standard_normal((30, 2)))
    return cols, vals, rows, x


def test_wrapper_rejects_what_the_kernel_cannot_take():
    cols, vals, rows, x = _small_bucket_tensors()
    with pytest.raises(TypeError, match="value dtype"):
        sell_core.spmm_sell(cols, vals, rows, x.float(), n_rows=30)
    with pytest.raises(TypeError, match="int32"):
        sell_core.spmm_sell(tuple(c.long() for c in cols), vals, rows, x,
                            n_rows=30)
    with pytest.raises(ValueError, match=r"\(S, C\)"):
        sell_core.spmm_sell(cols, vals, tuple(r[:, :-1] for r in rows), x,
                            n_rows=30)
    with pytest.raises(ValueError, match="contiguous"):
        sell_core.spmm_sell(tuple(c.transpose(1, 2) for c in cols),
                            tuple(v.transpose(1, 2) for v in vals), rows, x,
                            n_rows=30)
    with pytest.raises(ValueError, match=r"\(n_cols, k\)"):
        sell_core.spmm_sell(cols, vals, rows, x[:, 0], n_rows=30)
    with pytest.raises(TypeError, match="float32 or float64"):
        sell_core.spmm_sell(cols, vals, rows, x.half(), n_rows=30)
    with pytest.raises(ValueError, match="on meta"):
        sell_core.spmm_sell(tuple(c.to("meta") for c in cols), vals, rows, x,
                            n_rows=30)


def test_cpu_tensors_take_the_plain_path_and_count_no_launch(monkeypatch):
    def no_library(name):
        raise AssertionError("the CUDA library must not load for CPU tensors")

    monkeypatch.setattr(cuda_lib, "library", no_library)
    cols, vals, rows, x = _small_bucket_tensors()
    before = sell_core.KERNEL_LAUNCHES
    y = sell_core.spmm_sell(cols, vals, rows, x, n_rows=30)
    assert sell_core.KERNEL_LAUNCHES == before
    torch.testing.assert_close(
        y, sell_core.spmm_sell_ref(cols, vals, rows, x, n_rows=30),
        rtol=0, atol=0)


def test_other_devices_raise_instead_of_falling_back():
    cols, vals, rows, x = _small_bucket_tensors()
    meta = lambda ts: tuple(t.to("meta") for t in ts)   # noqa: E731
    with pytest.raises(RuntimeError, match="CUDA kernel and a CPU reference"):
        sell_core.spmm_sell(meta(cols), meta(vals), meta(rows), x.to("meta"),
                            n_rows=30)


def test_kernel_build_is_keyed_on_the_source_and_lands_in_build_dir():
    source, out = cuda_lib._target("spmm_sell")
    assert source.name == "spmm_sell.cu" and source.exists()
    assert out.parent == cuda_lib.BUILD_DIR
    assert out.parent.parent.name == "build"
    assert out.name.startswith("libspmm_sell-") and out.suffix == ".so"
    assert "arch=compute_90a,code=sm_90a" in cuda_lib.NVCC_FLAGS
    text = source.read_text()
    assert "repro/kernels/sell_core.py::_spmm_kernel" in text


def test_missing_nvcc_is_a_clear_error(monkeypatch):
    monkeypatch.setattr(cuda_lib.shutil, "which", lambda name: None)
    monkeypatch.setattr(cuda_lib.os.path, "exists", lambda p: False)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        cuda_lib._nvcc()


# ---------------------------------------------------------------------------
# Kernel B1's split of wide buckets across threads (the tuner and the plan)
# ---------------------------------------------------------------------------

#: big (random_csr(2_097_152, 2_097_152, 16.0, seed=0, skew=1.0)) packed at
#: C = 32: (W, slices) of every bucket at sigma 256 (csr_to_sell_slabs'
#: default) and at the tuned sigma 1024 (the registry's layout)
BIG_BUCKETS = {
    256: ((2, 195), (4, 9195), (8, 15538), (16, 16428), (32, 13984),
          (64, 2006), (128, 2315), (256, 4863), (512, 935), (1024, 75),
          (2048, 2)),
    1024: ((1, 1028), (2, 3574), (4, 8892), (8, 14813), (16, 16712),
           (32, 12144), (64, 5674), (128, 663), (256, 1192), (512, 769),
           (1024, 73), (2048, 2)),
}


def test_big_bucket_shapes_are_the_packers():
    """The table above is what the packer's own helpers give for big's row
    lengths (the lognormal law of ``random_csr``, drawn without building
    the 33.6M entries)."""
    n = 2_097_152
    rng = np.random.default_rng(0)
    lengths = np.clip(np.round(rng.lognormal(np.log(16.0) - 0.5, 1.0, n))
                      .astype(np.int64), 1, n)
    assert int(lengths.sum()) == 33_576_516 and int(lengths.max()) == 1438
    for sigma, buckets in BIG_BUCKETS.items():
        order = F.sigma_sort_order(lengths, sigma)
        widths = F.next_pow2(F.slice_widths(lengths, order, 32))
        got = tuple((int(w), int(s)) for w, s in
                    zip(*np.unique(widths, return_counts=True)))
        assert got == buckets


@pytest.mark.parametrize("sigma", sorted(BIG_BUCKETS))
@pytest.mark.parametrize("k_tile,itemsize", [(1, 8), (32, 8), (4, 4)])
def test_split_keeps_every_walk_under_its_bound(sigma, k_tile, itemsize):
    """At big's bucket shapes: a bucket from SPMM_SPLIT_WIDTH on is split,
    no thread walks more than SPMM_SPLIT_MAX_CHAIN entries nor fewer than
    SPMM_SPLIT_MIN_CHAIN, a block is at most 1,024 threads (rows x parts)
    and its partial sums fit 48 KB; narrower buckets keep one thread a
    row.  The W = 2048 bucket's walk falls from 2,048 steps to 16."""
    from repro_torch.core import autotune as A

    for w, s in BIG_BUCKETS[sigma]:
        split = A.spmm_split(w, 32, s, k_tile, itemsize)
        if w < A.SPMM_SPLIT_WIDTH:
            assert split.parts == 1 and split.smem_bytes == 0
            assert split.threads == A.SPMM_BLOCK_THREADS
            continue
        assert split.parts > 1
        chain = -(-w // split.parts)                   # entries a thread walks
        assert A.SPMM_SPLIT_MIN_CHAIN <= chain <= A.SPMM_SPLIT_MAX_CHAIN
        assert split.threads == split.lanes * split.parts \
            <= A.spmm_split_max_threads(k_tile) <= 1024
        assert split.lanes >= 8 and split.lanes & (split.lanes - 1) == 0
        assert split.k_chunk == min(k_tile, A.SPMM_SPLIT_K_CHUNK)
        assert split.smem_bytes == split.threads * split.k_chunk * itemsize
        assert split.smem_bytes <= 48 * 1024
    widest = A.spmm_split(2048, 32, 2, k_tile, itemsize)
    assert 2048 // widest.parts == (16 if k_tile <= 4 else 64)
    assert widest.threads == A.spmm_split_max_threads(k_tile)


def test_split_follows_the_slice_count_and_spares_narrow_buckets():
    """A wide bucket with rows enough to fill the card is split only as far
    as its walk bound asks; one with few rows is split further, to the
    shortest walk.  Narrow buckets (the MoE envelopes' routing widths 2 and
    8, every W below SPMM_SPLIT_WIDTH) are never split, whatever their
    slice count."""
    from repro_torch.core import autotune as A

    assert A.spmm_split(256, 32, 1 << 20).parts == 256 // A.SPMM_SPLIT_MAX_CHAIN
    assert A.spmm_split(256, 32, 1).parts == 256 // A.SPMM_SPLIT_MIN_CHAIN
    assert A.spmm_split(512, 32, 935).parts == 16      # 29,920 rows x 16
    for w in (1, 2, 8, 64, A.SPMM_SPLIT_WIDTH // 2):
        for s in (1, 64, 1 << 16):
            for kt in (1, 32):
                assert A.spmm_split(w, 32, s, kt).parts == 1
    # very wide: parts stop at SPMM_SPLIT_MAX_PARTS, 8 rows a block; at a
    # wide RHS tile the register budget stops them earlier
    huge = A.spmm_split(1 << 14, 32, 1)
    assert huge.parts == A.SPMM_SPLIT_MAX_PARTS and huge.lanes == 8
    wide_k = A.spmm_split(1 << 14, 32, 1, k_tile=32)
    assert wide_k.parts == 32 and wide_k.lanes == 8 and wide_k.threads == 256


def test_splits_names_the_layouts_b1_splits_at_every_rhs_tile():
    """``sell_core.splits`` is true exactly when a bucket reaches
    SPMM_SPLIT_WIDTH, and agrees with ``spmm_split`` at every RHS tile and
    element size (whether B1 splits depends on the bucket's shape only)."""
    from repro_torch.core import autotune as A

    short = F.random_csr(300, 250, 6.0, seed=1)
    assert not sell_core.splits(F.csr_to_sell_slabs(short, c=32).bucket_cols)
    lengths = np.full(64, 3)
    lengths[5] = A.SPMM_SPLIT_WIDTH
    indptr = np.concatenate([[0], np.cumsum(lengths)])
    rng = np.random.default_rng(2)
    wide = F.CSRMatrix(
        indptr=indptr,
        indices=np.concatenate([np.sort(rng.choice(200, n, replace=False))
                                for n in lengths]).astype(np.int32),
        data=rng.standard_normal(indptr[-1]), n_cols=200)
    cols = F.csr_to_sell_slabs(wide, c=8).bucket_cols
    assert sell_core.splits(cols)
    assert not sell_core.splits(cols[:-1])
    for sigma in BIG_BUCKETS:
        for w, s in BIG_BUCKETS[sigma]:
            shape = torch.empty((s, w, 32), dtype=torch.int32, device="meta")
            for kt, itemsize in ((1, 8), (4, 4), (8, 8), (32, 8)):
                assert sell_core.splits([shape]) == (
                    A.spmm_split(w, 32, s, kt, itemsize).parts > 1
                ) == (w >= A.SPMM_SPLIT_WIDTH)


def test_plan_prices_the_split_blocks():
    """plan_spmm_sell at big's sigma-256 shapes: a split bucket's launch is
    rows x parts threads, grid ceil(S * C / rows), with the partial sums'
    shared memory priced; a narrow one keeps SPMM_BLOCK_THREADS threads
    and claims none."""
    import dataclasses
    import math

    from repro_torch.analysis import SlabMeta, plan_spmm_sell
    from repro_torch.core import autotune as A

    slabs = F.csr_to_sell_slabs(F.random_csr(300, 250, 6.0, seed=1), c=32)
    widths, slices = zip(*BIG_BUCKETS[256])
    meta = dataclasses.replace(
        SlabMeta.from_slabs(slabs), widths=widths, n_slices=slices,
        n_rows=2_097_152, n_cols=2_097_152)
    for k, k_block in ((1, 1), (32, 32)):
        plan = plan_spmm_sell(meta, k=k, x_dtype="float64", k_block=k_block)
        assert plan.ok and plan.n_launches == len(widths)
        for blk, w, s in zip(plan.blocks, widths, slices):
            split = A.spmm_split(w, 32, s, k, 8)
            if split.parts == 1:
                assert blk.label == f"bucket{widths.index(w)}[W={w}]"
                assert blk.block == (A.SPMM_BLOCK_THREADS,)
                assert blk.grid == (math.ceil(s * 32 / 256), 1)
                assert blk.smem_bytes == 0
            else:
                assert f"split={split.parts}x{split.lanes}" in blk.label
                assert blk.block == (split.lanes * split.parts,)
                assert blk.grid == (math.ceil(s * 32 / split.lanes), 1)
                assert blk.smem_bytes == split.smem_bytes > 0
    assert sum(b.smem_bytes > 0 for b in plan.blocks) == 5    # W >= 128



# ---------------------------------------------------------------------------
# Kernel B3's lane groups and split (autotune.node_split)
# ---------------------------------------------------------------------------

#: The graph path's SELL buckets at C = 32, (width, slices): uniform21
#: (random_graph(2^21, 16, seed=0)) and rmat15 (rmat_graph(2^15, 16,
#: seed=0)), as their registration reports them.
GRAPH_BUCKETS = {
    "uniform21": ((16, 29604), (32, 35456), (64, 476)),
    "rmat15": ((1, 581), (2, 85), (4, 88), (8, 87), (16, 58), (32, 47),
               (64, 38), (128, 4), (256, 19), (1024, 11), (2048, 5),
               (8192, 1)),
}


@pytest.mark.parametrize("graph", sorted(GRAPH_BUCKETS))
@pytest.mark.parametrize("k_tile,itemsize", [(32, 8), (32, 4), (1, 8),
                                             (1, 4), (8, 8)])
def test_node_split_at_the_graph_paths_bucket_shapes(graph, k_tile,
                                                     itemsize):
    """Lanes across the state columns: a group of k_tile x itemsize / 16
    lanes a node (16 for PageRank fp64 at k = 32, 8 for BFS int32, one at
    k = 1, where a thread walks a node).  From
    NODE_SPLIT_WIDTH on a bucket is split so that no group walks more than
    NODE_SPLIT_MAX_CHAIN slots nor fewer than NODE_SPLIT_MIN_CHAIN, a block
    is at most 1,024 threads and its combine fits 48 KB; narrower buckets
    are not split.  rmat15's one W = 8192 slice no longer walks 8,192
    dependent steps a thread."""
    from repro_torch.analysis import SlabMeta
    from repro_torch.analysis.preflight import plan_bfs_sell, plan_pagerank_sell
    from repro_torch.core import autotune as A

    group = {(32, 8): 16, (32, 4): 8, (1, 8): 1, (1, 4): 1, (8, 8): 4}
    combine = "pagerank" if itemsize == 8 else "bfs"
    for w, s in GRAPH_BUCKETS[graph]:
        split = A.node_split(w, 32, s, k_tile, itemsize, combine)
        assert split.group == group[k_tile, itemsize]
        assert split.threads <= A.NODE_SPLIT_MAX_THREADS
        assert split.threads % 32 == 0
        if w < A.NODE_SPLIT_WIDTH:
            assert split.parts == 1 and split.smem_bytes == 0
            assert split.threads == A.NODE_STEP_BLOCK_THREADS
            continue
        assert split.parts > 1
        chain = -(-w // split.parts)                  # slots a group walks
        assert A.NODE_SPLIT_MIN_CHAIN <= chain <= A.NODE_SPLIT_MAX_CHAIN \
            or split.threads == A.NODE_SPLIT_MAX_THREADS
        assert split.smem_bytes <= 48 * 1024
        want = (split.nodes * split.parts * k_tile * 8 if itemsize == 8
                else 4 * split.nodes)
        assert split.smem_bytes == want
    if graph == "rmat15":
        widest = A.node_split(8192, 32, 1, k_tile, itemsize, combine)
        assert 8192 // widest.parts <= 128
        assert widest.nodes == 1 and widest.threads == 1024
    # the plans mirror it, bucket by bucket
    meta = SlabMeta(kind="graph", c=32,
                    widths=tuple(w for w, _ in GRAPH_BUCKETS[graph]),
                    n_slices=tuple(s for _, s in GRAPH_BUCKETS[graph]),
                    n_rows=1 << 15, n_cols=1 << 15, val_dtype=None,
                    idx_dtype="int32")
    plan = (plan_pagerank_sell(meta, k=k_tile) if itemsize == 8
            else plan_bfs_sell(meta, k=k_tile))
    assert plan.ok
    for b, (w, s) in zip(plan.blocks, GRAPH_BUCKETS[graph]):
        split = A.node_split(w, 32, s, k_tile, itemsize, combine)
        assert b.block == (split.threads,)
        assert b.grid == (-(-s * 32 // split.nodes), 1)
        assert b.smem_bytes == split.smem_bytes
