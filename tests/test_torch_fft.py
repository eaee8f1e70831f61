"""Parity of the port's FFT path (``repro_torch.kernels.fft``, ``ops.fft``
and its preflight) with the JAX reference.

The same numpy-seeded signals go through both packages.  The reference's
Pallas kernel runs in interpret mode with x64 on (as
``tests/test_kernels.py`` runs it); the port runs on the CPU because the
spec asks for it, where :func:`fft_stockham` takes its plain PyTorch path.
Tolerance, the reference's own against numpy (``tests/test_kernels.py``):
fp64 rtol 1e-9 / atol 1e-9 * n, fp32 rtol 1e-3 / atol 1e-3 * n.  Kernel B7
itself is held against the plain version on the card
(``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""
import dataclasses
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from repro.analysis.preflight import plan_fft_stockham as ref_plan
from repro.kernels import ops as ref_ops
from repro.kernels import ref as ref_ref
from repro.kernels.execspec import ExecSpec as RefExecSpec
from repro_torch.analysis import LaunchPlanError, plan_fft_stockham
from repro_torch.core import autotune
from repro_torch.kernels import fft, ops
from repro_torch.kernels.execspec import ExecSpec

CPU = ExecSpec(device="cpu")
TOLS = {np.float64: 1e-9, np.float32: 1e-3}


def _signal(batch, n, seed, dtype=np.float64):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((batch, n)).astype(dtype),
            rng.standard_normal((batch, n)).astype(dtype))


def _both(re, im, b_block=8):
    """The reference's and the port's ``ops.fft`` on the same planes."""
    want = ref_ops.fft(re, im, spec=RefExecSpec(b_block=b_block,
                                                interpret=True))
    got = ops.fft(re, im, spec=dataclasses.replace(CPU, b_block=b_block))
    return [np.asarray(w) for w in want], [g.numpy() for g in got]


def _close(got, want, n, tol):
    for g, w in zip(got, want):
        np.testing.assert_allclose(g, w, rtol=tol, atol=tol * n)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n", [2, 8, 64, 512, 2048])
def test_fft_matches_reference_and_numpy(n, dtype):
    re, im = _signal(4, n, seed=n, dtype=dtype)
    want, got = _both(re, im, b_block=2)
    tol = TOLS[dtype]
    assert got[0].shape == (4, n) and got[0].dtype == dtype
    _close(got, want, n, tol)
    spec = np.fft.fft(re.astype(np.float64) + 1j * im.astype(np.float64))
    _close(got, (spec.real, spec.imag), n, tol)


@pytest.mark.parametrize("batch,b_block", [(1, 8), (3, 2), (8, 8), (13, 4)])
def test_fft_batch_tails(batch, b_block):
    n = 128
    re, im = _signal(batch, n, seed=batch)
    want, got = _both(re, im, b_block=b_block)
    assert got[0].shape == (batch, n)
    _close(got, want, n, 1e-9)


def test_fft_one_d_input_and_no_imaginary_plane():
    n = 256
    re, _ = _signal(1, n, seed=3)
    want = ref_ops.fft(re[0], spec=RefExecSpec(interpret=True))
    got = ops.fft(re[0], spec=CPU)
    assert tuple(got[0].shape) == (1, n)
    _close([g.numpy() for g in got], [np.asarray(w) for w in want], n, 1e-9)
    spec = np.fft.fft(re[0])
    _close([g.numpy()[0] for g in got], (spec.real, spec.imag), n, 1e-9)
    # a torch tensor signal is accepted as it is
    got_t = ops.fft(torch.from_numpy(re), spec=CPU)
    torch.testing.assert_close(got_t[0], got[0], rtol=0, atol=0)


def test_fft_result_does_not_depend_on_b_block():
    re, im = _signal(13, 64, seed=5)
    base = ops.fft(re, im, spec=dataclasses.replace(CPU, b_block=1))
    for bb in (2, 3, 8, 64):
        got = ops.fft(re, im, spec=dataclasses.replace(CPU, b_block=bb))
        for g, b in zip(got, base):
            torch.testing.assert_close(g, b, rtol=0, atol=0)


@pytest.mark.parametrize("dtype", [np.float64, np.float32])
@pytest.mark.parametrize("n", [2, 8, 1024, 1 << 12])
def test_fft_twiddles_match_reference(n, dtype):
    want = ref_ref.fft_twiddles(n, dtype)
    got = fft.fft_twiddles(n, dtype)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == (int(math.log2(n)), n // 2)
        np.testing.assert_array_equal(g, np.asarray(w))


def test_fft_stockham_ref_matches_reference_plain_version():
    n = 512
    re, im = _signal(3, n, seed=11)
    wre, wim = fft.fft_twiddles(n)
    want = ref_ref.fft_stockham_ref(*(jnp.asarray(a) for a in (re, im, wre,
                                                               wim)))
    got = fft.fft_stockham_ref(*(torch.from_numpy(a) for a in (re, im, wre,
                                                               wim)))
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-12,
                                   atol=1e-12 * n)


# ---------------------------------------------------------------------------
# Preflight
# ---------------------------------------------------------------------------


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("b_block", [1, 8])
def test_plan_accepts_whatever_the_reference_accepts(b_block, dtype):
    """Every (n, batch, dtype) the reference's VMEM-budgeted plan accepts,
    the Hopper plan accepts too (its only limit is a block's shared
    memory, which the per-stage form does not claim)."""
    accepted = 0
    for logn in range(1, 20):
        n = 1 << logn
        for batch in (1, 8, 13):
            want = ref_plan(n, batch, b_block=b_block, dtype=dtype)
            got = plan_fft_stockham(n, batch, b_block=b_block, dtype=dtype)
            if want.ok:
                accepted += 1
                assert got.ok, (n, batch, got.violations)
    assert accepted >= 3 * 16
    for plan in (ref_plan(1000, 8, b_block=b_block, dtype=dtype),
                 plan_fft_stockham(1000, 8, b_block=b_block, dtype=dtype)):
        assert not plan.ok and "power of two" in plan.violations[0]


def test_plan_chooses_the_form_by_shared_memory():
    # fp64: one signal needs 32 n bytes of ping-pong buffers
    p = plan_fft_stockham(2048, 8192, b_block=8, dtype="float64")
    (blk,) = p.blocks
    assert p.n_launches == 1 and blk.label == "in_block[signals=3]"
    assert blk.smem_bytes == 3 * 32 * 2048 <= autotune.SMEM_PER_BLOCK
    assert blk.grid == (math.ceil(8192 / 3),) and blk.block == (1024,)
    assert plan_fft_stockham(4096, 5, dtype="float64").n_launches == 1
    big = plan_fft_stockham(8192, 5, dtype="float64")
    assert big.n_launches == 13 and all(b.smem_bytes == 0 for b in big.blocks)
    assert big.blocks[0].grid == (math.ceil(5 * 4096 / 256),)
    # fp32 fits twice the length
    assert plan_fft_stockham(8192, 5, dtype="float32").n_launches == 1
    assert plan_fft_stockham(1 << 17, 256, dtype="float64").n_launches == 17
    # small signals: b_block signals a block, threads rounded up to a warp
    small = plan_fft_stockham(8, 13, b_block=8, dtype="float64").blocks[0]
    assert small.grid == (2,) and small.block == (32,)
    assert autotune.fft_block_signals(2048, 8, 8) == 3
    assert autotune.fft_block_signals(8192, 8, 8) == 0


def test_fft_refusals_in_both_packages():
    for n in (1000, 6):
        sig = np.ones((2, n))
        with pytest.raises(ValueError, match="power of two"):
            ref_ops.fft(sig, spec=RefExecSpec(interpret=True))
        with pytest.raises(ValueError, match="power of two"):
            ops.fft(sig, spec=CPU)
    with pytest.raises(LaunchPlanError, match="power of two"):
        ops.fft(np.ones((2, 1)), spec=CPU)
    with pytest.raises(LaunchPlanError, match="float32 or float64"):
        ops.fft(np.ones((2, 8), np.int64), spec=CPU)


def test_fft_wrapper_contract_and_cpu_launch_count():
    re, im = (torch.from_numpy(a) for a in _signal(3, 16, seed=1))
    wre, wim = (torch.from_numpy(w) for w in fft.fft_twiddles(16))
    before = dict(fft.KERNEL_LAUNCHES)
    out = fft.fft_stockham(re, im, wre, wim, b_block=2)
    assert fft.KERNEL_LAUNCHES == before     # CPU tensors: the plain path
    ref = fft.fft_stockham_ref(re, im, wre, wim)
    for o, r in zip(out, ref):
        torch.testing.assert_close(o, r, rtol=0, atol=0)
    with pytest.raises(ValueError, match="power of two"):
        fft.fft_stockham(re[:, :12], im[:, :12], wre, wim)
    with pytest.raises(ValueError, match="twiddles"):
        fft.fft_stockham(re, im, wre[:, :4], wim[:, :4])
    with pytest.raises(TypeError, match="dtype"):
        fft.fft_stockham(re, im.float(), wre, wim)
    with pytest.raises(ValueError, match="b_block"):
        fft.fft_stockham(re, im, wre, wim, b_block=0)
