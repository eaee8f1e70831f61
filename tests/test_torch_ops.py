"""Parity of the port's entry points (``repro_torch.kernels.ops``) with
``repro.kernels.ops``, plus the Hopper launch preflight and the refusals.

Both packages see the same numpy-seeded operands; the reference runs its
Pallas kernels in interpret mode, the port runs on the CPU because the
spec asks for it (``ExecSpec(device="cpu")``).  Tolerance 1e-10 at fp64.
"""
import dataclasses

import numpy as np
import pytest
import torch

import repro_torch.core.autotune as autotune
from repro.kernels import ops as ref_ops
from repro.kernels.execspec import ExecSpec as RefExecSpec
from repro.sparse import formats as RF
from repro_torch.analysis import LaunchPlanError, SlabMeta, plan_spmm_sell
from repro_torch.kernels import ops
from repro_torch.kernels.execspec import ExecSpec, resolve_device
from repro_torch.obs import LaunchProfiler, profiled
from repro_torch.service.tunecache import TuneCache
from repro_torch.sparse import formats as F

TOL = 1e-10
CPU = ExecSpec(device="cpu")


def _pair(n_rows=90, n_cols=80, avg=5.0, seed=2, skew=1.0, dtype=np.float64):
    ref = RF.random_csr(n_rows, n_cols, avg, seed=seed, skew=skew, dtype=dtype)
    return ref, F.CSRMatrix(indptr=ref.indptr, indices=ref.indices,
                            data=ref.data, n_cols=ref.n_cols)


def _np(t):
    return t.cpu().numpy()


# ---------------------------------------------------------------------------
# spmv / spmm against the reference, every supported format
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("fmt", ["csr", "sell", "slabs"])
def test_spmv_matches_reference_every_format(fmt):
    ref, port = _pair()
    make = {
        "csr": (lambda m, fmod: m),
        "sell": (lambda m, fmod: fmod.csr_to_sell(m, c=16)),
        "slabs": (lambda m, fmod: fmod.csr_to_sell_slabs(m, c=16, sigma=32)),
    }[fmt]
    x = np.random.default_rng(1).standard_normal(80)
    want = np.asarray(ref_ops.spmv(make(ref, RF), x,
                                   spec=RefExecSpec(vl=16, interpret=True)))
    got = ops.spmv(make(port, F), x, spec=dataclasses.replace(CPU, vl=16))
    assert got.shape == (90,) and got.dtype == torch.float64
    np.testing.assert_allclose(_np(got), want, rtol=TOL, atol=TOL)
    np.testing.assert_allclose(_np(got), port.matvec(x), rtol=TOL, atol=TOL)


@pytest.mark.parametrize("k,k_block", [(1, None), (3, 2), (7, 4), (16, 32)])
def test_spmm_matches_reference(k, k_block):
    ref, port = _pair(seed=k)
    x = np.random.default_rng(k).standard_normal((80, k))
    want = np.asarray(ref_ops.spmm(ref, x, spec=RefExecSpec(
        vl=8, k_block=k_block, interpret=True)))
    got = ops.spmm(port, x, spec=dataclasses.replace(CPU, vl=8,
                                                     k_block=k_block))
    assert tuple(got.shape) == (90, k)
    np.testing.assert_allclose(_np(got), want, rtol=TOL, atol=TOL)
    # a stacked RHS through spmv dispatches to spmm
    via_spmv = ops.spmv(port, x, spec=dataclasses.replace(CPU, vl=8,
                                                          k_block=k_block))
    torch.testing.assert_close(via_spmv, got, rtol=0, atol=0)


def test_spmm_accepts_torch_rhs_and_fp32_operands():
    ref, port = _pair(seed=5, dtype=np.float32)
    x = np.random.default_rng(0).standard_normal((80, 2)).astype(np.float32)
    got = ops.spmm(port, torch.from_numpy(x), spec=dataclasses.replace(CPU, vl=32))
    want = np.asarray(ref_ops.spmm(ref, x, spec=RefExecSpec(vl=32,
                                                            interpret=True)))
    assert got.dtype == torch.float32
    np.testing.assert_allclose(_np(got), want, rtol=1e-5, atol=1e-5)


def test_spmm_rejects_1d():
    _, port = _pair()
    with pytest.raises(ValueError, match=r"\(n_cols, k\)"):
        ops.spmm(port, np.ones(80), spec=CPU)


# ---------------------------------------------------------------------------
# X's rows against the operand's columns (ROADMAP C: the reference clamps
# the gather, the port refuses a short X before anything runs)
# ---------------------------------------------------------------------------


def _short_x_cases():
    """(name, call) for every branch that gathers X: the SELL branch of
    spmv and spmm, the ELLPACK branch (kernel B6) of both, moe_dispatch
    (SELL and dense); each call takes X."""
    _, port = _pair()
    ell = F.csr_to_ellpack(port, c=8)
    ell_spec = dataclasses.replace(CPU, vl=8)
    return {
        "spmv_sell": lambda x: ops.spmv(port, x[:, 0], spec=CPU),
        "spmm_sell": lambda x: ops.spmm(port, x, spec=CPU),
        "spmv_slabs": lambda x: ops.spmv(
            F.csr_to_sell_slabs(port, c=32), x[:, 0], spec=CPU),
        "spmv_ellpack": lambda x: ops.spmv(ell, x[:, 0], spec=ell_spec),
        "spmm_ellpack": lambda x: ops.spmm(ell, x, spec=ell_spec),
        "moe_sell": lambda x: ops.moe_dispatch(
            port, x, spec=dataclasses.replace(CPU, dispatch="sell"), top_k=64),
        "moe_dense": lambda x: ops.moe_dispatch(
            port, x, spec=dataclasses.replace(CPU, dispatch="dense"),
            top_k=64),
    }


@pytest.mark.parametrize("case", sorted(_short_x_cases()))
def test_short_x_is_refused_before_anything_runs(case, monkeypatch):
    """An X with fewer rows than n_cols (80) is a ValueError naming both
    numbers, raised before the operand is scanned or uploaded, planned or
    launched (the kernels would gather past X's end on the card)."""
    from repro_torch.kernels import fft, sell_core, spmv

    def untouched(*args, **kwargs):
        raise AssertionError("reached past the X check")

    for name in ("_prepared", "_normalize_matrix", "_routing_dense",
                 "csr_to_sell_slabs"):
        monkeypatch.setattr(ops, name, untouched)
    call = _short_x_cases()[case]
    before = (sell_core.KERNEL_LAUNCHES, sell_core.STREAM_LAUNCHES,
              spmv.KERNEL_LAUNCHES, dict(fft.KERNEL_LAUNCHES))
    x = np.random.default_rng(3).standard_normal((79, 2))
    for short in (x, torch.from_numpy(x)):
        with pytest.raises(ValueError, match=r"X has 79 rows.*n_cols=80"):
            call(short)
    assert (sell_core.KERNEL_LAUNCHES, sell_core.STREAM_LAUNCHES,
            spmv.KERNEL_LAUNCHES, dict(fft.KERNEL_LAUNCHES)) == before


def test_longer_x_is_accepted_and_matches_the_reference():
    """A longer X is accepted, as in the reference: only its first n_cols
    rows are read, so the result equals the one on those rows.  (The dense
    MoE counterfactual is one matrix product, which needs X's rows to be
    the routing's columns, in both packages.)"""
    ref, port = _pair()
    x = np.random.default_rng(4).standard_normal((95, 3))
    cases = _short_x_cases()
    for name, call in cases.items():
        if name == "moe_dense":
            continue
        got = call(x)
        exact = call(x[:80])
        torch.testing.assert_close(got, exact, rtol=0, atol=0)
    want = np.asarray(ref_ops.spmm(ref, x, spec=RefExecSpec(
        vl=32, interpret=True)))
    np.testing.assert_allclose(_np(cases["spmm_sell"](x)), want, rtol=TOL,
                               atol=TOL)
    want = np.asarray(ref_ops.spmv(ref, x[:, 0], spec=RefExecSpec(
        vl=32, interpret=True)))
    np.testing.assert_allclose(_np(cases["spmv_sell"](x)), want, rtol=TOL,
                               atol=TOL)


# ---------------------------------------------------------------------------
# Repack-on-mismatch memo (ops.py:94-113, 297-306 of the reference)
# ---------------------------------------------------------------------------


def _count_packs(monkeypatch):
    packs = {"n": 0}
    real = ops.csr_to_sell_slabs

    def counting(*args, **kwargs):
        packs["n"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(ops, "csr_to_sell_slabs", counting)
    return packs


def test_mismatched_slabs_repack_once_and_match_reference(monkeypatch):
    ref, port = _pair(seed=7)
    x = np.random.default_rng(2).standard_normal(80)
    cache = TuneCache()
    packs = _count_packs(monkeypatch)
    slabs16 = F.csr_to_sell_slabs(port, c=16)
    spec = dataclasses.replace(CPU, vl=32, cache=cache)
    y1 = ops.spmv(slabs16, x, spec=spec)
    assert packs["n"] == 1                      # the first call repacks
    y2 = ops.spmv(slabs16, x, spec=spec)
    assert packs["n"] == 1                      # the second reuses it
    torch.testing.assert_close(y1, y2, rtol=0, atol=0)
    assert sum(cache.repacks.values()) == 1
    want = np.asarray(ref_ops.spmv(RF.csr_to_sell_slabs(ref, c=16), x,
                                   spec=RefExecSpec(vl=32, interpret=True)))
    np.testing.assert_allclose(_np(y1), want, rtol=TOL, atol=TOL)


def test_default_cache_memoizes_across_calls(monkeypatch):
    monkeypatch.setattr(ops, "_DEFAULT_CACHE", None)
    _, port = _pair(seed=8)
    x = np.random.default_rng(3).standard_normal(80)
    packs = _count_packs(monkeypatch)
    sell8 = F.csr_to_sell(port, c=8)
    ops.spmv(sell8, x, spec=dataclasses.replace(CPU, vl=16))
    ops.spmv(sell8, x, spec=dataclasses.replace(CPU, vl=16))
    assert packs["n"] == 1
    assert sum(ops.default_tune_cache().repacks.values()) == 1
    ops.reset_default_tune_cache()
    assert ops._DEFAULT_CACHE is None


# ---------------------------------------------------------------------------
# Tuned packing through the cache
# ---------------------------------------------------------------------------


def test_pack_tuned_is_pay_once(monkeypatch):
    calls = {"n": 0}
    real = autotune.measured_pad_factor

    def counting(*args, **kwargs):
        calls["n"] += 1
        return real(*args, **kwargs)

    monkeypatch.setattr(autotune, "measured_pad_factor", counting)
    _, port = _pair(n_rows=200, n_cols=200, seed=0)
    cache = TuneCache()
    slabs1, tuned1 = ops.pack_tuned(port, cache=cache, device="cpu")
    assert calls["n"] > 0 and tuned1.k_block == 32 and tuned1.c % 32 == 0
    calls["n"] = 0
    slabs2, tuned2 = ops.pack_tuned(port, cache=cache, device="cpu")
    assert calls["n"] == 0 and slabs2 is slabs1
    assert (tuned2.c, tuned2.sigma) == (tuned1.c, tuned1.sigma)
    x = np.random.default_rng(0).standard_normal(200)
    y = ops.spmv(slabs2, x, spec=dataclasses.replace(
        CPU, vl=tuned2.c, k_block=tuned2.k_block))
    np.testing.assert_allclose(_np(y), port.matvec(x), rtol=TOL, atol=TOL)


def test_slab_scan_and_upload_happen_once_per_operand(monkeypatch):
    """Repeated calls on one packed operand scan its column indices and
    upload its slabs once; the memo entry dies with the operand."""
    calls = {"scan": 0, "upload": 0}
    real_scan, real_upload = SlabMeta.from_slabs, F.SellSlabs.to_device

    def scan(slabs, check_bounds=False):
        calls["scan"] += 1
        return real_scan(slabs, check_bounds=check_bounds)

    def upload(self, device):
        calls["upload"] += 1
        return real_upload(self, device)

    monkeypatch.setattr(SlabMeta, "from_slabs", scan)
    monkeypatch.setattr(F.SellSlabs, "to_device", upload)
    _, port = _pair()
    slabs = F.csr_to_sell_slabs(port, c=8)
    rng = np.random.default_rng(5)
    spec = dataclasses.replace(CPU, vl=8)
    for _ in range(3):
        x = rng.standard_normal(80)
        np.testing.assert_allclose(_np(ops.spmv(slabs, x, spec=spec)),
                                   port.matvec(x), rtol=TOL, atol=TOL)
    ops.spmm(slabs, rng.standard_normal((80, 4)), spec=spec)
    assert calls == {"scan": 1, "upload": 1}
    key = id(slabs)
    assert key in ops._PREPARED
    del slabs
    assert key not in ops._PREPARED


def test_device_tag_names_the_device():
    assert ops.device_tag("cpu") == "cpu"


# ---------------------------------------------------------------------------
# Refusals: no silent substitute for what is not ported
# ---------------------------------------------------------------------------


def test_unported_paths_raise_not_implemented():
    ref, port = _pair()
    x = np.ones(80)
    # the streaming schedule runs now (kernel B2's plain version here) and
    # agrees with the reference's
    want = np.asarray(ref_ops.spmv(ref, x, spec=RefExecSpec(
        vl=256, mode="stream", interpret=True)))
    got = ops.spmv(port, x, spec=dataclasses.replace(CPU, mode="stream"))
    np.testing.assert_allclose(_np(got), want, rtol=TOL, atol=TOL)
    # a placement runs the sharded drives now; one over more CUDA devices
    # than are visible raises when the call resolves it, with no fallback
    if torch.cuda.device_count() < 2:
        with pytest.raises(ValueError, match="only .* CUDA device"):
            ops.spmv(port, x, spec=dataclasses.replace(CPU, placement=2))
    # ELLPACK operands run now (kernel B6); the reference's container is
    # not the port's, and stays an unsupported format
    np.testing.assert_allclose(
        _np(ops.spmv(F.csr_to_ellpack(port, c=8), x, spec=CPU)),
        port.matvec(x), rtol=TOL, atol=TOL)
    with pytest.raises(TypeError, match="unsupported sparse format"):
        ops.spmv(RF.csr_to_ellpack(ref, c=8), x, spec=CPU)
    with pytest.raises(ValueError, match="unknown mode"):
        ops.spmv(port, x, spec=dataclasses.replace(CPU, mode="fast"))
    with pytest.raises(TypeError, match="unsupported sparse format"):
        ops.spmv(object(), x, spec=CPU)
    assert ExecSpec(placement=1).n_devices() == 1


def test_cuda_request_without_a_gpu_raises():
    if torch.cuda.is_available():
        pytest.skip("a GPU is present: the default device is valid here")
    _, port = _pair()
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        ops.spmv(port, np.ones(80))                 # default: the card
    with pytest.raises(RuntimeError, match="no CUDA GPU"):
        resolve_device(None)
    with pytest.raises(ValueError, match="unsupported device"):
        resolve_device("meta")


def test_exec_spec_mirrors_the_reference_fields():
    ref_fields = [f.name for f in dataclasses.fields(RefExecSpec)]
    fields = [f.name for f in dataclasses.fields(ExecSpec)]
    assert fields == [("device" if f == "interpret" else f) for f in ref_fields]
    key, ref_key = ExecSpec().coalesce_key(), RefExecSpec().coalesce_key()
    assert len(key) == len(ref_key)
    assert key[:-1] == ref_key[:-1]          # last slot: interpret -> device
    assert ExecSpec(cache=TuneCache()).coalesce_key() == key


# ---------------------------------------------------------------------------
# Hopper launch preflight
# ---------------------------------------------------------------------------


def _meta(c=32, seed=1):
    slabs = F.csr_to_sell_slabs(F.random_csr(300, 250, 6.0, seed=seed,
                                             skew=1.0), c=c)
    return slabs, SlabMeta.from_slabs(slabs, check_bounds=True)


def test_plan_mirrors_the_kernel_launch():
    slabs, meta = _meta()
    plan = plan_spmm_sell(meta, k=5, x_dtype="float64", k_block=4)
    assert plan.ok and plan.kernel == "spmm_sell"
    assert plan.n_launches == slabs.n_buckets
    for b, cols in zip(plan.blocks, slabs.bucket_cols):
        s, w, c = cols.shape
        # a wide bucket runs split across threads: rows x parts a block
        split = autotune.spmm_split(w, c, s, 4, 8)
        rows = split.lanes if split.parts > 1 else autotune.SPMM_BLOCK_THREADS
        assert b.grid == (-(-s * c // rows), 2)
        assert b.block == (split.threads,)
        assert b.smem_bytes == split.smem_bytes
    assert any(b.smem_bytes for b in plan.blocks)       # W = 128: split
    summary = plan.summary()
    assert summary["ok"] and summary["n_launches"] == slabs.n_buckets


def test_plan_rejects_what_the_kernel_cannot_take():
    slabs, meta = _meta()
    with pytest.raises(LaunchPlanError, match="k_block 6"):
        plan_spmm_sell(meta, k_block=6).raise_if_invalid()
    with pytest.raises(LaunchPlanError, match="register budget"):
        plan_spmm_sell(meta, k=64, k_block=64).raise_if_invalid()
    with pytest.raises(LaunchPlanError, match="float32"):
        plan_spmm_sell(meta, x_dtype="float32").raise_if_invalid()
    with pytest.raises(LaunchPlanError, match="grid.y"):
        plan_spmm_sell(meta, k=1 << 17, k_block=1).raise_if_invalid()
    half = dataclasses.replace(meta, val_dtype="float16")
    with pytest.raises(LaunchPlanError, match="not float32 or float64"):
        plan_spmm_sell(half).raise_if_invalid()
    oob = dataclasses.replace(meta, idx_max=meta.n_cols)
    with pytest.raises(LaunchPlanError, match="out of bounds"):
        plan_spmm_sell(oob).raise_if_invalid()
    with pytest.raises(TypeError, match="SellSlabs"):
        SlabMeta.from_slabs(object())


def test_ops_preflight_runs_before_any_launch():
    _, port = _pair()
    with pytest.raises(LaunchPlanError, match="k_block 6"):
        ops.spmm(port, np.ones((80, 2)), spec=dataclasses.replace(
            CPU, vl=8, k_block=6))
    with pytest.raises(LaunchPlanError, match="float32"):
        ops.spmm(port, np.ones((80, 2), np.float32),
                 spec=dataclasses.replace(CPU, vl=8))
    # a corrupt column index is caught by the bounds scan, not the gather
    slabs = F.csr_to_sell_slabs(port, c=8)
    bad_cols = tuple(c.copy() for c in slabs.bucket_cols)
    bad_cols[0][0, 0, 0] = port.n_cols + 5
    bad = dataclasses.replace(slabs, bucket_cols=bad_cols)
    with pytest.raises(LaunchPlanError, match="out of bounds"):
        ops.spmv(bad, np.ones(80), spec=dataclasses.replace(CPU, vl=8))


def test_installed_profiler_records_the_planned_launch():
    _, port = _pair()
    prof = LaunchProfiler()
    with profiled(prof):
        ops.spmv(port, np.ones(80), spec=dataclasses.replace(CPU, vl=16))
    (rec,) = prof.records()
    assert rec.op == "spmm" and rec.kernel == "spmm_sell"
    assert rec.planned_ok and rec.wall_us > 0
