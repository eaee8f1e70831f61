"""Kernel B1 (``csrc/spmm_sell.cu``) against its plain PyTorch version on
the card.  Every test here carries the ``cuda`` marker and skips without a
GPU (decided inside the fixture, never at import).  This file imports
neither ``jax`` nor ``repro``, so it runs on a machine that has only the
port's dependencies:

    PYTHONPATH=src python -m pytest -q --noconftest -m cuda tests/test_torch_cuda.py

Tolerance: 1e-10 at fp64, 1e-4 x max|y| at fp32 (summation order differs).
"""
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


@pytest.mark.cuda
def test_ops_spmv_on_the_card_matches_host_csr(cuda_device):
    csr = F.cage10_like(seed=0)
    x = np.random.default_rng(1).standard_normal(csr.n_cols)
    y = ops.spmv(csr, x, spec=ExecSpec(vl=32))          # default device: cuda
    assert y.device.type == "cuda"
    np.testing.assert_allclose(y.cpu().numpy(), csr.matvec(x),
                               rtol=1e-10, atol=1e-10)
