"""Batched radix-2 Stockham FFT on Hopper (paper §3.1, the fourth kernel).

Port of ``repro.kernels.fft`` and of the FFT half of ``repro.kernels.ref``.
Signals are split re/im planes of shape (batch, n), n a power of two; the
twiddle tables are pre-expanded per stage (:func:`fft_twiddles`), so each
of the log2 n stages is pure mul/add over the n/2 butterflies, and
Stockham's ping-pong between two buffers needs no bit reversal.

* :func:`fft_stockham` — the wrapper.  On CUDA tensors it launches the
  hand-written kernel ``csrc/fft_stockham.cu`` (kernel B7) or raises; on
  CPU tensors, and only there, it runs :func:`fft_stockham_ref`.  Two forms
  of the kernel: up to n = 4096 in fp64 and 8192 in fp32 one launch
  transforms whole signals a block (at most ``b_block``), each by n / 16
  threads that run radix-16 passes in registers and exchange through one
  shared buffer; longer signals run the two-pass (four-step) form: n = n1 *
  n2 (:func:`repro_torch.core.autotune.fft_two_pass`), one launch of length-n1
  FFTs down the columns of each signal's (n1, n2) view with the cross
  twiddles applied, one launch of length-n2 FFTs along the rows, both in
  shared memory, through one device scratch pair.  ``b_block`` only groups
  signals: it never changes the result.
* :func:`fft_stockham_ref` — the plain PyTorch version of the same
  function, for the CPU tests and for holding the kernel against.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.core.autotune import (
    fft_block_signals,
    fft_pass_threads,
    fft_two_pass,
)

__all__ = [
    "KERNEL_LAUNCHES",
    "fft_stockham",
    "fft_stockham_ref",
    "fft_twiddles",
]

#: Launches of kernel B7 in this process, counted where each is launched
#: and nowhere else: ``fft_stockham_block`` (the in-block form, one per
#: call) and ``fft_stockham_two_pass`` (the two-pass form, two per call).
KERNEL_LAUNCHES = {"fft_stockham_block": 0, "fft_stockham_two_pass": 0}

_KERNEL_DTYPES = (torch.float32, torch.float64)


def fft_twiddles(n: int, dtype=np.float64) -> tuple[np.ndarray, np.ndarray]:
    """Per-stage twiddle tables, pre-expanded to the (l, m) -> (n/2,) layout
    (a copy of ``repro.kernels.ref.fft_twiddles``).

    Stage s (l = n >> (s+1), m = 1 << s) multiplies the "bottom" halves by
    w_j = exp(-2*pi*i * j / (2l)), j in [0, l), each repeated m times.
    Computed in float64, then cast to ``dtype``.  Returns numpy (wre, wim)
    of shape (stages, n // 2).
    """
    stages = int(np.log2(n))
    half = n // 2
    wre = np.empty((stages, half))
    wim = np.empty((stages, half))
    l, m = half, 1
    for s in range(stages):
        j = np.arange(l)
        w = np.exp(-2j * np.pi * j / (2 * l))
        wre[s] = np.repeat(w.real, m)
        wim[s] = np.repeat(w.imag, m)
        l //= 2
        m *= 2
    return np.asarray(wre, dtype), np.asarray(wim, dtype)


def _check_args(re, im, wre, wim) -> tuple[int, int]:
    """Device, dtype, shape and contiguity of one call; returns (batch, n).
    The kernel computes raw offsets from these shapes."""
    if re.ndim != 2 or im.shape != re.shape:
        raise ValueError(f"re {tuple(re.shape)} / im {tuple(im.shape)} are "
                         "not one (batch, n) pair")
    batch, n = re.shape
    if n < 2 or n & (n - 1):
        raise ValueError(f"n must be a power of two >= 2, got {n}")
    stages = int(math.log2(n))
    if wre.shape != (stages, n // 2) or wim.shape != wre.shape:
        raise ValueError(f"twiddles {tuple(wre.shape)} / {tuple(wim.shape)} "
                         f"!= (log2 n, n/2) = {(stages, n // 2)}")
    if re.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"signal dtype {re.dtype} is not float32 or float64")
    for name, t in (("im", im), ("wre", wre), ("wim", wim)):
        if t.dtype != re.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != re dtype {re.dtype}")
        if t.device != re.device:
            raise ValueError(f"{name} on {t.device}, re on {re.device}")
    return batch, n


def fft_stockham_ref(re: torch.Tensor, im: torch.Tensor, wre: torch.Tensor,
                     wim: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched Stockham radix-2 FFT on split planes, in plain PyTorch (the
    stage loop of ``repro.kernels.ref.fft_stockham_ref``).

    ``re``/``im``: (batch, n).  Returns (batch, n) spectra matching
    ``torch.fft.fft`` up to fp error.  Runs on whatever device its tensors
    are on.
    """
    b, n = _check_args(re, im, wre, wim)
    stages = int(math.log2(n))
    half = n // 2
    l, m = half, 1
    xr, xi = re, im
    for s in range(stages):
        x0r = xr.reshape(b, 2, half)
        x0i = xi.reshape(b, 2, half)
        topr = x0r[:, 0] + x0r[:, 1]
        topi = x0i[:, 0] + x0i[:, 1]
        dr = x0r[:, 0] - x0r[:, 1]
        di = x0i[:, 0] - x0i[:, 1]
        botr = dr * wre[s] - di * wim[s]
        boti = dr * wim[s] + di * wre[s]
        # interleave (l, m) pairs: y[(j, h, k)] for h in {top, bot}
        yr = torch.stack([topr.reshape(b, l, m), botr.reshape(b, l, m)], dim=2)
        yi = torch.stack([topi.reshape(b, l, m), boti.reshape(b, l, m)], dim=2)
        xr = yr.reshape(b, n)
        xi = yi.reshape(b, n)
        l //= 2
        m *= 2
    return xr, xi


def _lib():
    from repro_torch.kernels import cuda_lib

    return cuda_lib.library("fft_stockham")


def _raise_on(err: int, lib, what: str) -> None:
    if err != 0:
        msg = lib.repro_fft_cuda_error_string(err).decode()
        raise RuntimeError(f"{what} kernel launch failed (cudaError {err}: {msg})")


def _launch_block(re, im, wre, wim, out_re, out_im, signals: int) -> None:
    """One launch of the in-block form: ``signals`` whole signals a block,
    :func:`~repro_torch.core.autotune.fft_block_radix` complex values a
    thread (the C entry works it out from n the same way), ``signals * n /
    radix`` threads and :func:`~repro_torch.core.autotune
    .fft_block_smem_bytes` of dynamic shared memory a block."""
    lib = _lib()
    batch, n = re.shape
    with torch.cuda.device(re.device):
        err = lib.repro_fft_stockham_block(
            re.data_ptr(), im.data_ptr(), wre.data_ptr(), wim.data_ptr(),
            out_re.data_ptr(), out_im.data_ptr(), batch, n,
            int(math.log2(n)), signals, int(re.dtype == torch.float64),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, lib, f"fft_stockham in-block ({batch}, {n}), {signals} "
                        "signals a block")
    KERNEL_LAUNCHES["fft_stockham_block"] += 1


def _launch_pass(cols: bool, xr, xi, wre, wim, yr, yi, n1: int,
                 tile: int) -> None:
    """One launch of the two-pass form: pass A (``cols``: length-n1 FFTs
    down ``tile`` columns a block, cross twiddles applied, planes (xr, xi)
    into scratch (yr, yi)) or pass B (length-n2 FFTs along ``tile`` rows a
    block, scratch into the output planes)."""
    lib = _lib()
    batch, n = xr.shape
    m = n1 if cols else n // n1
    with torch.cuda.device(xr.device):
        err = lib.repro_fft_pass(
            int(cols), xr.data_ptr(), xi.data_ptr(), wre.data_ptr(),
            wim.data_ptr(), yr.data_ptr(), yi.data_ptr(), batch, n,
            int(math.log2(n)), int(math.log2(n1)), int(math.log2(tile)),
            fft_pass_threads(m, tile), int(xr.dtype == torch.float64),
            torch.cuda.current_stream().cuda_stream)
    _raise_on(err, lib, f"fft_stockham two-pass {'A' if cols else 'B'} "
                        f"({batch}, {n}), n1={n1}, tile={tile}")
    KERNEL_LAUNCHES["fft_stockham_two_pass"] += 1


def fft_stockham(re: torch.Tensor, im: torch.Tensor, wre: torch.Tensor,
                 wim: torch.Tensor, *, b_block: int = 8
                 ) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched FFT of split-plane signals ``re``/``im`` of shape (batch, n).

    ``wre``/``wim`` come from :func:`fft_twiddles` (as tensors on the
    signals' device).  Returns the (batch, n) spectrum planes as new
    tensors on the signals' device.  On a CUDA device the in-block form of
    kernel B7 runs where a signal fits a block's shared memory (one launch,
    ``b_block`` signals a block at most), the two-pass form otherwise (two
    launches, :func:`repro_torch.core.autotune.fft_two_pass`; lengths past
    its reach raise); on the CPU the plain
    :func:`fft_stockham_ref` runs.
    """
    batch, n = _check_args(re, im, wre, wim)
    if b_block < 1:
        raise ValueError(f"b_block must be >= 1, got {b_block}")
    if re.device.type == "cpu":
        return fft_stockham_ref(re, im, wre, wim)
    if re.device.type != "cuda":
        raise RuntimeError(
            f"fft_stockham has a CUDA kernel and a CPU reference; got {re.device}")
    re, im, wre, wim = (t.contiguous() for t in (re, im, wre, wim))
    if batch == 0:
        return torch.empty_like(re), torch.empty_like(im)
    signals = fft_block_signals(n, b_block, re.element_size())
    if signals >= 1:
        out_re, out_im = torch.empty_like(re), torch.empty_like(im)
        _launch_block(re, im, wre, wim, out_re, out_im, signals)
        return out_re, out_im
    split = fft_two_pass(n, re.element_size())
    if split is None:
        raise ValueError(f"fft length {n} exceeds the two-pass form's reach "
                         "(n1 and n2 must each fit one block)")
    n1, _, tile_a, tile_b = split
    scratch = (torch.empty_like(re), torch.empty_like(im))
    out_re, out_im = torch.empty_like(re), torch.empty_like(im)
    _launch_pass(True, re, im, wre, wim, *scratch, n1, tile_a)
    _launch_pass(False, *scratch, wre, wim, out_re, out_im, n1, tile_b)
    return out_re, out_im
