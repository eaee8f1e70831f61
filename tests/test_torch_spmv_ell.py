"""Parity of the port's ELLPACK SpMV path (``EllpackMatrix`` and its
converters, ``repro_torch.kernels.spmv``, the ELLPACK branches of
``ops.spmv`` / ``ops.spmm`` and their preflight) with the JAX reference.

The same numpy-seeded matrices go through both packages.  The reference's
Pallas kernel runs in interpret mode with x64 on; the port runs on the CPU
because the spec asks for it, where :func:`spmv_ell` takes its plain
PyTorch path.  Tolerance 1e-10 at fp64.  Kernel B6 itself is held against
the plain version on the card (``tests/test_torch_cuda.py``,
``chip_smoke.py``).
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.kernels import spmv as ref_spmv
from repro.kernels.execspec import ExecSpec as RefExecSpec
from repro.service.tunecache import operand_signature as ref_signature
from repro.sparse import formats as RF
from repro_torch.analysis import LaunchPlanError, SlabMeta, plan_spmv_ell
from repro_torch.core import autotune
from repro_torch.kernels import ops, sell_core, spmv
from repro_torch.kernels.execspec import ExecSpec
from repro_torch.service.tunecache import TuneCache, operand_signature
from repro_torch.sparse import formats as F

TOL = 1e-10
CPU = ExecSpec(device="cpu")


def _pair(n_rows=90, n_cols=80, avg=5.0, seed=2, dtype=np.float64):
    ref = RF.random_csr(n_rows, n_cols, avg, seed=seed, dtype=dtype)
    return ref, F.CSRMatrix(indptr=ref.indptr, indices=ref.indices,
                            data=ref.data, n_cols=ref.n_cols)


def _ell_pair(c, width=None, **kw):
    ref, port = _pair(**kw)
    return ref, port, RF.csr_to_ellpack(ref, c=c, width=width), \
        F.csr_to_ellpack(port, c=c, width=width)


# ---------------------------------------------------------------------------
# The copied containers
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("c,width", [(8, None), (32, None), (16, 3),
                                     (16, 40), (128, None)])
def test_ellpack_containers_match_reference(c, width):
    """``csr_to_ellpack``, ``ellpack_to_csr``, ``to_csr`` and the
    container's properties are byte-identical to the reference's, the
    short-``width`` quirk (entries past it dropped, nnz unchanged)
    included."""
    ref, port, rell, pell = _ell_pair(c, width, n_rows=101, seed=c)
    assert pell.cols.tobytes() == rell.cols.tobytes()
    assert pell.vals.tobytes() == rell.vals.tobytes()
    assert pell.cols.dtype == rell.cols.dtype and \
        pell.vals.dtype == rell.vals.dtype
    for attr in ("n_rows", "n_cols", "nnz", "c", "width", "n_slices",
                 "padded_nnz", "pad_factor"):
        assert getattr(pell, attr) == getattr(rell, attr), attr
    x = np.random.default_rng(c).standard_normal(80)
    np.testing.assert_array_equal(pell.matvec(x), rell.matvec(x))
    for got, want in ((F.ellpack_to_csr(pell), RF.ellpack_to_csr(rell)),
                      (F.to_csr(pell), RF.to_csr(rell))):
        for a in ("indptr", "indices", "data"):
            assert getattr(got, a).tobytes() == getattr(want, a).tobytes()
        assert got.n_cols == want.n_cols
    if width == 3:
        assert F.ellpack_to_csr(pell).nnz < pell.nnz


def test_ellpack_operand_signature_matches_reference():
    _, _, rell, pell = _ell_pair(16)
    got, want = operand_signature(pell), ref_signature(rell)
    assert got.kind == "ellpack" and got.key == want.key
    assert (got.n_rows, got.n_cols, got.nnz) == \
        (want.n_rows, want.n_cols, want.nnz)
    _, _, _, other = _ell_pair(16, seed=3)
    assert operand_signature(other).key != got.key


def test_ellpack_to_device_keeps_the_layout():
    _, _, _, pell = _ell_pair(16)
    cols, vals = pell.to_device("cpu")
    assert cols.dtype == torch.int32 and tuple(cols.shape) == pell.cols.shape
    assert cols.is_contiguous() and vals.dtype == torch.float64
    np.testing.assert_array_equal(vals.numpy(), pell.vals)


# ---------------------------------------------------------------------------
# The kernel wrapper and its plain version
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_spmv_ell_matches_reference_kernel_and_spmv_ref(dtype):
    ref, _, rell, pell = _ell_pair(32, dtype=dtype)
    x = np.random.default_rng(4).standard_normal(80).astype(dtype)
    want = np.asarray(ref_spmv.spmv_ell(
        jnp.asarray(rell.cols), jnp.asarray(rell.vals), jnp.asarray(x),
        w_block=4, interpret=True))
    cols, vals = pell.to_device("cpu")
    got = spmv.spmv_ell(cols, vals, torch.from_numpy(x), w_block=4)
    assert tuple(got.shape) == (pell.n_slices * pell.c,)
    tol = TOL if dtype == np.float64 else 1e-4 * float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=tol)
    np.testing.assert_allclose(
        got.numpy()[:ref.n_rows],
        np.asarray(ref_ref.spmv_ref(jnp.asarray(rell.cols),
                                    jnp.asarray(rell.vals), jnp.asarray(x),
                                    ref.n_rows)), rtol=0, atol=tol)
    assert not got.numpy()[ref.n_rows:].any()     # all-PAD rows write 0


def test_spmv_ell_wrapper_contract_and_cpu_launch_count():
    _, _, _, pell = _ell_pair(16)
    cols, vals = pell.to_device("cpu")
    x = torch.ones(80, dtype=torch.float64)
    before = spmv.KERNEL_LAUNCHES
    torch.testing.assert_close(spmv.spmv_ell(cols, vals, x),
                               spmv.spmv_ell_ref(cols, vals, x),
                               rtol=0, atol=0)
    assert spmv.KERNEL_LAUNCHES == before       # CPU tensors: the plain path
    with pytest.raises(TypeError, match="int32"):
        spmv.spmv_ell(cols.long(), vals, x)
    with pytest.raises(TypeError, match="dtype"):
        spmv.spmv_ell(cols, vals, x.float())
    with pytest.raises(ValueError, match="slab"):
        spmv.spmv_ell(cols[0], vals, x)
    with pytest.raises(ValueError, match="n_cols"):
        spmv.spmv_ell(cols, vals, x[:, None])
    with pytest.raises(ValueError, match="w_block"):
        spmv.spmv_ell(cols, vals, x, w_block=0)


# ---------------------------------------------------------------------------
# ops: B6 at C == vl, the repack to SELL otherwise
# ---------------------------------------------------------------------------


def _counting(monkeypatch, module, name):
    calls = {"n": 0}
    real = getattr(module, name)

    def counting(*args, **kwargs):
        calls["n"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(module, name, counting)
    return calls


@pytest.mark.parametrize("vl", [16, 64])
def test_spmv_ellpack_at_vl_runs_b6(vl, monkeypatch):
    _, port, rell, pell = _ell_pair(vl, n_rows=150)
    b6 = _counting(monkeypatch, spmv, "spmv_ell")
    b1 = _counting(monkeypatch, sell_core, "spmm_sell")
    x = np.random.default_rng(vl).standard_normal(80)
    want = np.asarray(ref_ops.spmv(rell, x, spec=RefExecSpec(
        vl=vl, interpret=True)))
    got = ops.spmv(pell, x, spec=dataclasses.replace(CPU, vl=vl))
    assert b6["n"] == 1 and b1["n"] == 0
    assert tuple(got.shape) == (150,) and got.dtype == torch.float64
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), port.matvec(x), rtol=TOL,
                               atol=TOL)


def test_spmv_ellpack_of_another_height_repacks_to_sell(monkeypatch):
    _, port, rell, pell = _ell_pair(8)
    b6 = _counting(monkeypatch, spmv, "spmv_ell")
    b1 = _counting(monkeypatch, sell_core, "spmm_sell")
    x = np.random.default_rng(0).standard_normal(80)
    cache = TuneCache()
    want = np.asarray(ref_ops.spmv(rell, x, spec=RefExecSpec(
        vl=32, interpret=True)))
    spec = dataclasses.replace(CPU, vl=32, cache=cache)
    got = ops.spmv(pell, x, spec=spec)
    ops.spmv(pell, x, spec=spec)                 # memoized repack
    assert b6["n"] == 0 and b1["n"] == 2
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(got.numpy(), port.matvec(x), rtol=TOL,
                               atol=TOL)
    assert len(cache.repacks) == 1
    assert next(iter(cache.repacks)).startswith(
        f"repack|{operand_signature(pell).key}|c32")


@pytest.mark.parametrize("vl", [16, 32])
def test_spmm_ellpack_matches_reference_column_by_column(vl, monkeypatch):
    _, port, rell, pell = _ell_pair(16, n_rows=70)
    b6 = _counting(monkeypatch, spmv, "spmv_ell")
    b6k = _counting(monkeypatch, spmv, "spmm_ell")
    x = np.random.default_rng(1).standard_normal((80, 3))
    want = np.asarray(ref_ops.spmm(rell, x, spec=RefExecSpec(
        vl=vl, interpret=True)))
    got = ops.spmm(pell, x, spec=dataclasses.replace(CPU, vl=vl))
    # the reference walks the columns one B6 call each; the port makes one
    # call of B6's k-column form for the whole stack
    assert b6["n"] == 0 and b6k["n"] == (1 if vl == 16 else 0)
    assert tuple(got.shape) == (70, 3)
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)
    # a stacked RHS through spmv dispatches to spmm
    via_spmv = ops.spmv(pell, x, spec=dataclasses.replace(CPU, vl=vl))
    torch.testing.assert_close(via_spmv, got, rtol=0, atol=0)


@pytest.mark.parametrize("w_block", [1, 4, 16])
def test_spmv_w_blocking_invariant(w_block):
    _, _, rell, pell = _ell_pair(64, n_rows=200, avg=12.0)
    x = np.random.default_rng(7).standard_normal(80)
    base = ops.spmv(pell, x, spec=dataclasses.replace(CPU, vl=64))
    got = ops.spmv(pell, x, spec=dataclasses.replace(CPU, vl=64,
                                                     w_block=w_block))
    torch.testing.assert_close(got, base, rtol=0, atol=0)
    want = np.asarray(ref_ops.spmv(rell, x, spec=RefExecSpec(
        vl=64, w_block=w_block, interpret=True)))
    np.testing.assert_allclose(got.numpy(), want, rtol=TOL, atol=TOL)


def test_stream_mode_with_ellpack_raises_value_error_in_both_packages():
    _, _, rell, pell = _ell_pair(16)
    x = np.ones(80)
    for fn, arg in ((ref_ops.spmv, x), (ref_ops.spmm, x[:, None])):
        with pytest.raises(ValueError, match="requires a SELL slab layout"):
            fn(rell, arg, spec=RefExecSpec(vl=16, mode="stream",
                                           interpret=True))
    for fn, arg in ((ops.spmv, x), (ops.spmm, x[:, None])):
        with pytest.raises(ValueError, match="requires a SELL slab layout"):
            fn(pell, arg, spec=dataclasses.replace(CPU, vl=16, mode="stream"))
    with pytest.raises(ValueError, match="unknown mode"):
        ops.spmv(pell, x, spec=dataclasses.replace(CPU, vl=16, mode="fast"))


def test_fp32_ellpack_and_dtype_mismatch():
    _, port, _, pell = _ell_pair(16, dtype=np.float32)
    x = np.random.default_rng(2).standard_normal(80).astype(np.float32)
    got = ops.spmv(pell, x, spec=dataclasses.replace(CPU, vl=16))
    assert got.dtype == torch.float32
    want = port.matvec(x)
    np.testing.assert_allclose(got.numpy(), want, rtol=0,
                               atol=1e-4 * float(np.abs(want).max()))
    with pytest.raises(LaunchPlanError, match="x dtype float64"):
        ops.spmv(pell, x.astype(np.float64),
                 spec=dataclasses.replace(CPU, vl=16))


# ---------------------------------------------------------------------------
# Preflight
# ---------------------------------------------------------------------------


def test_plan_spmv_ell_shape_and_bounds():
    _, _, _, pell = _ell_pair(32, n_rows=150)
    meta = SlabMeta.from_ellpack(pell, check_bounds=True)
    assert meta.kind == "ellpack" and meta.widths == (pell.width,)
    plan = plan_spmv_ell(meta, dtype="float64").raise_if_invalid()
    (blk,) = plan.blocks
    threads = autotune.ELL_BLOCK_THREADS
    assert plan.kernel == "spmv_ell" and blk.grid == (-(-160 // threads),)
    assert blk.block == (threads,) and plan.n_launches == 1
    cols = pell.cols.copy()
    cols[0, 0, 3] = pell.n_cols
    bad = F.EllpackMatrix(cols=cols, vals=pell.vals, n_rows=pell.n_rows,
                          n_cols=pell.n_cols, nnz=pell.nnz)
    with pytest.raises(LaunchPlanError, match="out of bounds for n_cols"):
        ops.spmv(bad, np.ones(80), spec=dataclasses.replace(CPU, vl=32))
    cols[0, 0, 3] = -5
    with pytest.raises(LaunchPlanError, match="below the PAD sentinel"):
        ops.spmv(F.EllpackMatrix(cols=cols, vals=pell.vals, n_rows=150,
                                 n_cols=80, nnz=pell.nnz), np.ones(80),
                 spec=dataclasses.replace(CPU, vl=32))
    graphs_meta = SlabMeta.from_ell(np.zeros((4, 2), np.int32), 4)
    assert not plan_spmv_ell(graphs_meta).ok


def test_ellpack_scan_and_upload_are_memoized(monkeypatch):
    _, _, _, pell = _ell_pair(16)
    calls = {"scan": 0}
    real = SlabMeta.from_ellpack.__func__

    def counting(cls, *args, **kwargs):
        calls["scan"] += 1
        return real(cls, *args, **kwargs)

    monkeypatch.setattr(SlabMeta, "from_ellpack", classmethod(counting))
    spec = dataclasses.replace(CPU, vl=16)
    for _ in range(3):
        ops.spmv(pell, np.ones(80), spec=spec)
    ops.spmm(pell, np.ones((80, 2)), spec=spec)
    assert calls["scan"] == 1
    key = id(pell)
    assert key in ops._PREPARED
    del pell
    assert key not in ops._PREPARED


# ---------------------------------------------------------------------------
# The k-column form, the live widths and their plan
# ---------------------------------------------------------------------------


def _live_count(cols: np.ndarray) -> np.ndarray:
    """Brute-force live widths: per 32 consecutive rows (row r = lane r % C
    of slice r // C), 1 + the last slot holding a non-PAD column."""
    s, w, c = cols.shape
    rows = np.zeros(s * c, np.int64)
    for si in range(s):
        for lane in range(c):
            for wi in range(w):
                if cols[si, wi, lane] != F.PAD:
                    rows[si * c + lane] = wi + 1
    out = np.zeros(-(-s * c // 32), np.int64)
    for r, v in enumerate(rows):
        out[r // 32] = max(out[r // 32], v)
    return out


def _holey(pell, seed):
    """``pell`` with PAD punched into random slots, inside rows too, and a
    whole 32-row group of PAD when there is room for one."""
    rng = np.random.default_rng(seed)
    cols, vals = pell.cols.copy(), pell.vals.copy()
    holes = rng.random(cols.shape) < 0.3
    cols[holes], vals[holes] = F.PAD, 0.0
    flat_c = cols.transpose(0, 2, 1).reshape(-1, cols.shape[1])
    if flat_c.shape[0] >= 64:
        flat_c[32:64] = F.PAD
        cols = flat_c.reshape(cols.shape[0], cols.shape[2],
                              cols.shape[1]).transpose(0, 2, 1).copy()
        vals = np.where(cols == F.PAD, 0.0, vals).astype(vals.dtype)
    return F.EllpackMatrix(cols=np.ascontiguousarray(cols),
                           vals=np.ascontiguousarray(vals), n_rows=pell.n_rows,
                           n_cols=pell.n_cols, nnz=int((cols != F.PAD).sum()))


@pytest.mark.parametrize("c", [8, 32, 48, 128])
def test_live_widths_match_a_numpy_count_with_pad_inside_rows(c):
    _, _, _, pell = _ell_pair(c, n_rows=300, avg=7.0, seed=c)
    for ell in (pell, _holey(pell, c)):
        cols = torch.from_numpy(ell.cols)
        got = spmv.live_widths(cols)
        assert got.dtype == torch.int32 and got.is_contiguous()
        np.testing.assert_array_equal(got.numpy(), _live_count(ell.cols))
    holey = _holey(pell, c)
    assert (_live_count(holey.cols) == 0).any()     # a whole group of PAD


@pytest.mark.parametrize("k", [1, 2, 3, 8, 32, 33])
@pytest.mark.parametrize("dtype", [np.float64, np.float32])
def test_spmm_ell_ref_matches_reference_column_by_column(k, dtype):
    """The k-column plain version against the reference's ``ops.spmm``
    (one B6 call a column) and bit-equal to the column-by-column plain
    walk, PAD inside rows included."""
    _, _, rell, pell = _ell_pair(16, n_rows=90, dtype=dtype, seed=k)
    ell = _holey(pell, k)
    rell = RF.EllpackMatrix(cols=ell.cols, vals=ell.vals, n_rows=ell.n_rows,
                            n_cols=ell.n_cols, nnz=ell.nnz)
    x = np.random.default_rng(k).standard_normal((80, k)).astype(dtype)
    cols, vals = ell.to_device("cpu")
    X = torch.from_numpy(x)
    got = spmv.spmm_ell_ref(cols, vals, X)
    assert tuple(got.shape) == (ell.n_slices * ell.c, k)
    cbc = torch.stack([spmv.spmv_ell_ref(cols, vals, X[:, i].contiguous())
                       for i in range(k)], dim=1)
    assert torch.equal(got, cbc)
    assert torch.equal(spmv.spmm_ell(cols, vals, X), got)   # CPU: plain
    want = np.asarray(ref_ops.spmm(rell, x, spec=RefExecSpec(
        vl=16, interpret=True)))
    tol = TOL if dtype == np.float64 else 1e-4 * float(np.abs(want).max())
    np.testing.assert_allclose(got.numpy()[:ell.n_rows], want, rtol=0,
                               atol=tol)
    via_ops = ops.spmm(ell, x, spec=dataclasses.replace(CPU, vl=16))
    assert torch.equal(via_ops, got[:ell.n_rows])


@pytest.mark.parametrize("k,itemsize,aligned,want", [
    (32, 8, True, [(0, 32, 16)]),              # one launch, 16 B a lane
    (32, 4, True, [(0, 32, 8)]),
    (64, 8, True, [(0, 64, 32)]),
    (33, 8, True, [(0, 32, 32), (32, 1, 1)]),  # odd k: one column a lane
    (3, 4, True, [(0, 3, 4)]),
    (2, 8, True, [(0, 2, 1)]),
    (8, 8, False, [(0, 8, 8)]),                # X not 16 B aligned
    (130, 8, True, [(0, 64, 32), (64, 64, 32), (128, 2, 1)]),
])
def test_ell_k_tiles(k, itemsize, aligned, want):
    from repro_torch.core import autotune

    vec = autotune.ell_vec(k, itemsize, aligned)
    tiles = autotune.ell_k_tiles(k, vec)
    assert tiles == want
    assert sum(kt for _, kt, _ in tiles) == k
    for k0, kt, group in tiles:
        assert k0 % vec == 0 and group <= autotune.WARP
        assert (group // 2) * vec < kt <= group * vec   # fewest lanes, pow2


def test_plan_spmm_ell_tiles_and_refusals():
    from repro_torch.analysis import LiveWidthMeta

    _, _, _, pell = _ell_pair(32, n_rows=150)
    meta = SlabMeta.from_ellpack(pell, check_bounds=True)
    live = LiveWidthMeta.from_array(_live_count(pell.cols))
    assert live.n == 5 and 0 <= live.lo <= live.hi <= pell.width
    plan = plan_spmv_ell(meta, dtype="float64", k=32, live=live)
    assert plan.ok and plan.kernel == "spmm_ell" and plan.n_launches == 1
    assert plan.blocks[0].grid == (-(-160 // (autotune.ELL_BLOCK_THREADS // 16)),)
    assert plan_spmv_ell(meta, k=33, live=live).n_launches == 2
    for bad, match in (
            (LiveWidthMeta(4, 0, 3), "hold 4 entries, want 5"),
            (LiveWidthMeta(5, 0, pell.width + 1), "outside"),
            (LiveWidthMeta(5, -1, 2), "outside")):
        plan = plan_spmv_ell(meta, k=1, live=bad)
        assert any(match in v for v in plan.violations), plan.violations
    wide = plan_spmv_ell(meta, dtype="float64", k=130, live=live)
    assert wide.ok and wide.n_launches == 3     # 64 + 64 + 2 columns
    assert [b.grid for b in wide.blocks] == [(-(-160 // (
        autotune.ELL_BLOCK_THREADS // g)),) for g in (32, 32, 1)]


def test_ops_caches_live_widths_and_the_plan_refuses_bad_ones(monkeypatch):
    _, _, _, pell = _ell_pair(16, n_rows=100)
    spec = dataclasses.replace(CPU, vl=16)
    calls = _counting(monkeypatch, spmv, "live_widths")
    for _ in range(2):
        ops.spmm(pell, np.ones((80, 4)), spec=spec)
        ops.spmv(pell, np.ones(80), spec=spec)
    assert calls["n"] == 1
    _, (_, _, live) = ops._prepared(pell, torch.device("cpu"))
    np.testing.assert_array_equal(live.numpy(), _live_count(pell.cols))
    from repro_torch.analysis import LiveWidthMeta

    ops._PREPARED[id(pell)]["live"] = LiveWidthMeta(live.numel(), 0,
                                                    pell.width + 3)
    before = spmv.KERNEL_LAUNCHES
    with pytest.raises(LaunchPlanError, match="live widths"):
        ops.spmm(pell, np.ones((80, 4)), spec=spec)
    assert spmv.KERNEL_LAUNCHES == before


def test_spmm_ell_wrapper_contract():
    _, _, _, pell = _ell_pair(16)
    cols, vals = pell.to_device("cpu")
    X = torch.ones((80, 3), dtype=torch.float64)
    with pytest.raises(ValueError, match=r"\(n_cols, k\)"):
        spmv.spmm_ell(cols, vals, X[:, 0])
    with pytest.raises(TypeError, match="dtype"):
        spmv.spmm_ell(cols, vals, X.float())
    live = spmv.live_widths(cols)
    with pytest.raises(ValueError, match="live widths of shape"):
        spmv.spmm_ell(cols, vals, X, live_width=live[:-1])
    with pytest.raises(TypeError, match="int32"):
        spmv.spmv_ell(cols, vals, X[:, 0].contiguous(),
                      live_width=live.long())


@pytest.mark.parametrize("k", [None, 3])
def test_handed_live_widths_are_bounded_to_the_slab(k):
    """Live widths handed to the wrappers are bounded to ``[0, W]`` by the
    walk, on the plain path as in the kernel: W + 5 in every warp gives
    the true widths' result (the slots past a warp's last entry are PAD),
    -1 walks no slot, so that warp's 32 rows read 0 and the others are
    unchanged; ``cut_to_live`` is the slab the walk reads."""
    _, _, _, pell = _ell_pair(32, n_rows=300, avg=7.0, seed=4)
    cols, vals = pell.to_device("cpu")
    rng = np.random.default_rng(5)
    shape = (pell.n_cols,) if k is None else (pell.n_cols, k)
    x = torch.from_numpy(rng.standard_normal(shape))
    fn, ref = ((spmv.spmv_ell, spmv.spmv_ell_ref) if k is None
               else (spmv.spmm_ell, spmv.spmm_ell_ref))
    live = spmv.live_widths(cols)
    want = ref(cols, vals, x)
    assert torch.equal(fn(cols, vals, x, live_width=live), want)
    over = torch.full_like(live, pell.width + 5)
    assert torch.equal(spmv.cut_to_live(cols, over), cols)
    assert torch.equal(fn(cols, vals, x, live_width=over), want)
    neg = live.clone()
    neg[1] = -1
    got = fn(cols, vals, x, live_width=neg)
    warp = (torch.arange(got.shape[0]) // 32) == 1
    assert not got[warp].any()
    assert torch.equal(got[~warp], want[~warp])
    cut = spmv.cut_to_live(cols, neg).permute(0, 2, 1).reshape(-1, pell.width)
    assert (cut[warp] == F.PAD).all()
    assert torch.equal(cut[~warp], cols.permute(0, 2, 1).reshape(
        -1, pell.width)[~warp])
