"""ELLPACK SpMV on Hopper: the paper's baseline format (kernel B6).

Port of ``repro.kernels.spmv`` (and of ``repro.kernels.ref.spmv_ref``).
The matrix is uniform-width ELLPACK in the slice-transposed layout
(S, W, C): element (s, w, c) is the w-th nonzero of row ``s*C + c``, PAD
(-1) columns are masked.  y has ``S * C`` entries; callers trim it to
``n_rows``.

* :func:`spmv_ell` — the wrapper.  On CUDA tensors it launches the
  hand-written kernel ``csrc/spmv_ell.cu`` (one thread per row, the width
  walked in registers) or raises; on CPU tensors, and only there, it runs
  :func:`spmv_ell_ref`.
* :func:`spmv_ell_ref` — the plain PyTorch version of the same function.
"""
from __future__ import annotations

import torch

from repro_torch.core.autotune import SPMM_BLOCK_THREADS
from repro_torch.sparse.formats import PAD

__all__ = ["KERNEL_LAUNCHES", "spmv_ell", "spmv_ell_ref"]

#: Launches of kernel B6 by :func:`spmv_ell` in this process: one per call
#: on CUDA tensors, counted where the kernel is launched and nowhere else.
KERNEL_LAUNCHES = 0

_KERNEL_DTYPES = (torch.float32, torch.float64)


def _check_args(cols, vals, x) -> None:
    """Device, dtype, shape and contiguity of one launch.  Column bounds
    are the preflight's job
    (:func:`repro_torch.analysis.preflight.plan_spmv_ell`)."""
    if cols.ndim != 3 or vals.shape != cols.shape:
        raise ValueError(f"cols {tuple(cols.shape)} / vals {tuple(vals.shape)}"
                         " are not one (S, W, C) slab")
    if x.ndim != 1:
        raise ValueError(f"x must be (n_cols,), got shape {tuple(x.shape)}")
    if cols.dtype != torch.int32:
        raise TypeError(f"cols must be int32, got {cols.dtype}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"x dtype {x.dtype} is not float32 or float64")
    if vals.dtype != x.dtype:
        raise TypeError(f"value dtype {vals.dtype} != x dtype {x.dtype}")
    for name, t in (("cols", cols), ("vals", vals)):
        if t.device != x.device:
            raise ValueError(f"{name} on {t.device}, x on {x.device}")
        if not t.is_contiguous():
            raise ValueError(f"{name} is not contiguous")


def spmv_ell_ref(cols: torch.Tensor, vals: torch.Tensor,
                 x: torch.Tensor) -> torch.Tensor:
    """y = A @ x over the padded (S, W, C) layout, in plain PyTorch: every
    row sums ``vals[s, w, c] * x[cols[s, w, c]]`` over w = 0 .. W-1 in
    ascending order, PAD entries contributing exactly zero.  Returns y of
    shape (S * C,) on the tensors' device."""
    _check_args(cols, vals, x)
    n_slices, width, c = cols.shape
    acc = torch.zeros((n_slices, c), dtype=x.dtype, device=x.device)
    for w in range(width):
        col = cols[:, w, :]
        mask = col != PAD
        acc += torch.where(mask, vals[:, w, :] * x[torch.where(mask, col, 0)
                                                   .long()], 0)
    return acc.reshape(-1)


def _launch(cols, vals, x, y) -> None:
    """One launch of kernel B6 on PyTorch's current stream of x's device,
    made with that device current."""
    global KERNEL_LAUNCHES
    from repro_torch.kernels import cuda_lib

    lib = cuda_lib.library("spmv_ell")
    n_slices, width, c = cols.shape
    with torch.cuda.device(x.device):
        err = lib.repro_spmv_ell(
            cols.data_ptr(), vals.data_ptr(), x.data_ptr(), y.data_ptr(),
            n_slices, width, c, SPMM_BLOCK_THREADS,
            int(x.dtype == torch.float64),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.repro_spmv_ell_cuda_error_string(err).decode()
        raise RuntimeError(
            f"spmv_ell kernel launch failed (cudaError {err}: {msg}) for a "
            f"({n_slices}, {width}, {c}) slab")
    KERNEL_LAUNCHES += 1


def spmv_ell(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor, *,
             w_block: int = 8) -> torch.Tensor:
    """y = A @ x for A in slice-transposed ELLPACK (S, W, C).

    Returns y of shape (S * C,) on x's device; callers trim to n_rows.  On
    a CUDA device one launch of kernel B6 (one thread per row); on the CPU
    the plain :func:`spmv_ell_ref`.  ``w_block`` is the reference's width
    tile: one thread walks the whole width, so it does not change the
    result.
    """
    _check_args(cols, vals, x)
    if w_block < 1:
        raise ValueError(f"w_block must be >= 1, got {w_block}")
    if x.device.type == "cpu":
        return spmv_ell_ref(cols, vals, x)
    if x.device.type != "cuda":
        raise RuntimeError(
            f"spmv_ell has a CUDA kernel and a CPU reference; got {x.device}")
    x = x.contiguous()
    n_slices, _, c = cols.shape
    y = torch.empty(n_slices * c, dtype=x.dtype, device=x.device)
    if y.numel():
        _launch(cols, vals, x, y)
    return y
