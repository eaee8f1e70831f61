"""Fused Mamba2 SSD chunked scan on Hopper (kernel B8).

Port of ``repro.kernels.ssd``.  Per (batch, head) and chunk of ``chunk``
rows the scan takes the running sum ``cum`` of ``ad`` in the chunk and
computes ``y = (C Bᵀ ∘ L) x + e^{cum} · C stateᵀ`` with the causal decay
``L[i, j] = e^{cum_i - cum_j}`` (i >= j), then carries
``state = state · e^{cum_last} + Σ_j e^{cum_last - cum_j} x_j ⊗ B_j`` into
the next chunk.  Heads share B and C per group (``h / g`` heads a group).

* :func:`ssd_fused` — the wrapper.  It plans the launch
  (:func:`repro_torch.analysis.preflight.plan_ssd_fused`: whole chunks,
  groups dividing heads, shared memory); on CUDA tensors it launches
  ``csrc/ssd_fused.cu`` (one block per (b, h) plane and slice of head
  columns, the chunk loop inside the block) or raises; on CPU tensors, and
  only there, it runs :func:`ssd_fused_ref`.
* :func:`ssd_fused_ref` — the plain PyTorch version: a loop over chunks in
  the TPU kernel body's order (``ssd.py:26-53``), batched over (b, h).

Beyond the reference's ``ssd_fused`` both take an optional ``init_state``
(b, h, p, n), the contract of ``repro.models.ssm.ssd_chunked``, which the
model calls; with ``None`` the scan starts from zero, as ``ssd_fused`` does.
Accumulation is in promote(xd, float32): y comes back in xd's dtype, the
final state in the accumulation dtype.
"""
from __future__ import annotations

import torch

from repro_torch.analysis.preflight import plan_ssd_fused
from repro_torch.core.autotune import SSD_BLOCK_THREADS, ssd_p_block

__all__ = ["KERNEL_LAUNCHES", "segsum", "ssd_fused", "ssd_fused_ref"]

#: Launches of kernel B8 by :func:`ssd_fused` in this process: one per call
#: on CUDA tensors, counted where the kernel is launched and nowhere else.
KERNEL_LAUNCHES = 0

_KERNEL_DTYPES = (torch.float32, torch.float64)


def _check_args(xd, ad, B, C, init_state) -> tuple[int, int, int, int, int, int]:
    """Device, dtype and shape of one call; returns (b, l, h, p, g, n).
    Chunking and group counts are the plan's job."""
    if xd.ndim != 4:
        raise ValueError(f"xd must be (b, l, h, p), got {tuple(xd.shape)}")
    b, l, h, p = xd.shape
    if ad.shape != (b, l, h):
        raise ValueError(f"ad {tuple(ad.shape)} != (b, l, h) = {(b, l, h)}")
    if B.ndim != 4 or B.shape[:2] != (b, l) or C.shape != B.shape:
        raise ValueError(f"B {tuple(B.shape)} / C {tuple(C.shape)} are not "
                         f"one (b, l, g, n) pair for b={b}, l={l}")
    g, n = B.shape[2], B.shape[3]
    if xd.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"xd dtype {xd.dtype} is not float32 or float64")
    for name, t in (("ad", ad), ("B", B), ("C", C)):
        if t.dtype != xd.dtype:
            raise TypeError(f"{name} dtype {t.dtype} != xd dtype {xd.dtype}")
        if t.device != xd.device:
            raise ValueError(f"{name} on {t.device}, xd on {xd.device}")
    if init_state is not None:
        if init_state.shape != (b, h, p, n):
            raise ValueError(f"init_state {tuple(init_state.shape)} != "
                             f"(b, h, p, n) = {(b, h, p, n)}")
        if init_state.device != xd.device:
            raise ValueError(f"init_state on {init_state.device}, xd on "
                             f"{xd.device}")
    return b, l, h, p, g, n


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


def segsum(a: torch.Tensor) -> torch.Tensor:
    """Lower-triangular segment sums (the reference's ``ssm._segsum``):
    out[..., i, j] = sum_{k=j+1..i} a[..., k] for i >= j, -inf above the
    diagonal, so that its exp is the causal decay matrix with exact zeros
    above the diagonal (no exp of a positive sum)."""
    q = a.shape[-1]
    cum = torch.cumsum(a, dim=-1)
    diff = cum[..., :, None] - cum[..., None, :]
    tri = torch.ones((q, q), dtype=torch.bool, device=a.device).tril()
    return torch.where(tri, diff, float("-inf"))


def ssd_fused_ref(xd: torch.Tensor, ad: torch.Tensor, B: torch.Tensor,
                  C: torch.Tensor, *, chunk: int = 128,
                  init_state: torch.Tensor | None = None
                  ) -> tuple[torch.Tensor, torch.Tensor]:
    """The scan in plain PyTorch, chunk by chunk in the order of the TPU
    kernel's body, on whatever device its tensors are on.  Returns
    (y (b, l, h, p) in xd's dtype, final state (b, h, p, n))."""
    b, l, h, p, g, n = _check_args(xd, ad, B, C, init_state)
    plan_ssd_fused(b, l, h, p, g, n, chunk=chunk,
                   dtype=str(xd.dtype).removeprefix("torch.")).raise_if_invalid()
    acc = _acc_dtype(xd.dtype)
    grp = torch.arange(h, device=xd.device) // (h // g)
    state = (torch.zeros((b, h, p, n), dtype=acc, device=xd.device)
             if init_state is None else init_state.to(acc))
    y = torch.empty_like(xd)
    for c0 in range(0, l, chunk):
        sl = slice(c0, c0 + chunk)
        xc = xd[:, sl].to(acc).permute(0, 2, 1, 3)            # (b, h, q, p)
        ac = ad[:, sl].to(acc).permute(0, 2, 1)               # (b, h, q)
        bc = B[:, sl][:, :, grp].to(acc).permute(0, 2, 1, 3)  # (b, h, q, n)
        cc = C[:, sl][:, :, grp].to(acc).permute(0, 2, 1, 3)
        cum = torch.cumsum(ac, dim=-1)
        lmat = torch.exp(segsum(ac))                          # (b, h, q, q)
        gm = cc @ bc.transpose(-1, -2)                        # (b, h, q, q)
        yc = (gm * lmat) @ xc                                 # intra-chunk
        yc = yc + torch.exp(cum)[..., None] * (cc @ state.transpose(-1, -2))
        decay_end = torch.exp(cum[..., -1:] - cum)            # (b, h, q)
        new = (decay_end[..., None] * bc).transpose(-1, -2) @ xc   # (b, h, n, p)
        state = state * torch.exp(cum[..., -1])[..., None, None] \
            + new.transpose(-1, -2)
        y[:, sl] = yc.permute(0, 2, 1, 3).to(y.dtype)
    return y, state


def _launch(xd, ad, B, C, init, y, fstate, chunk: int, p_block: int) -> None:
    """One launch of kernel B8 on PyTorch's current stream of xd's device,
    made with that device current."""
    global KERNEL_LAUNCHES
    from repro_torch.kernels import cuda_lib

    lib = cuda_lib.library("ssd_fused")
    b, l, h, p = xd.shape
    g, n = B.shape[2], B.shape[3]
    with torch.cuda.device(xd.device):
        err = lib.repro_ssd_fused(
            xd.data_ptr(), ad.data_ptr(), B.data_ptr(), C.data_ptr(),
            None if init is None else init.data_ptr(), y.data_ptr(),
            fstate.data_ptr(), b, l, h, p, g, n, chunk, p_block,
            SSD_BLOCK_THREADS, int(xd.dtype == torch.float64),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.repro_ssd_cuda_error_string(err).decode()
        raise RuntimeError(
            f"ssd_fused kernel launch failed (cudaError {err}: {msg}) for "
            f"(b, l, h, p, g, n) = {(b, l, h, p, g, n)}, chunk {chunk}, "
            f"p_block {p_block}")
    KERNEL_LAUNCHES += 1


def ssd_fused(xd: torch.Tensor, ad: torch.Tensor, B: torch.Tensor,
              C: torch.Tensor, *, chunk: int = 128,
              init_state: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused scan.  xd (b, l, h, p) (inputs pre-multiplied by dt), ad
    (b, l, h), B and C (b, l, g, n), all float32 or all float64; l a
    multiple of ``chunk``.  Returns (y (b, l, h, p), final state
    (b, h, p, n)).  On a CUDA device one launch of kernel B8; on the CPU
    the plain :func:`ssd_fused_ref`.
    """
    b, l, h, p, g, n = _check_args(xd, ad, B, C, init_state)
    if xd.device.type == "cpu":
        return ssd_fused_ref(xd, ad, B, C, chunk=chunk, init_state=init_state)
    if xd.device.type != "cuda":
        raise RuntimeError(
            f"ssd_fused has a CUDA kernel and a CPU reference; got {xd.device}")
    plan_ssd_fused(b, l, h, p, g, n, chunk=chunk,
                   dtype=str(xd.dtype).removeprefix("torch.")).raise_if_invalid()
    xd, ad, B, C = (t.contiguous() for t in (xd, ad, B, C))
    acc = _acc_dtype(xd.dtype)
    init = None if init_state is None else init_state.to(acc).contiguous()
    y = torch.empty_like(xd)
    fstate = torch.empty((b, h, p, n), dtype=acc, device=xd.device)
    _launch(xd, ad, B, C, init, y, fstate, chunk, ssd_p_block(b, h, p))
    return y, fstate
