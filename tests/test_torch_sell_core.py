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
