"""Fused Mamba2 SSD chunked scan on Hopper (kernel B8).

Port of ``repro.kernels.ssd``.  Per (batch, head) and chunk of ``chunk``
rows the scan takes the running sum ``cum`` of ``ad`` in the chunk and
computes ``y = (C Bᵀ ∘ L) x + e^{cum} · C stateᵀ`` with the causal decay
``L[i, j] = e^{cum_i - cum_j}`` (i >= j), then carries
``state = state · e^{cum_last} + Σ_j e^{cum_last - cum_j} x_j ⊗ B_j`` into
the next chunk.  Heads share B and C per group (``h / g`` heads a group).

* :func:`ssd_fused` — the wrapper.  It plans the launches
  (:func:`repro_torch.analysis.preflight.plan_ssd_fused`: whole chunks,
  groups dividing heads, grid limits); on CUDA tensors it launches
  ``csrc/ssd_fused.cu`` in its chunk-parallel form, three launches a call
  (:data:`LAUNCHES_PER_CALL`: each chunk's local state, a pass over the
  chunks that carries the state, each chunk's output by 64-row query
  tiles, in fp32 on the tensor cores), or raises; on CPU tensors, and
  only there, it runs :func:`ssd_fused_ref`.
* :func:`ssd_fused_ref` — the plain PyTorch version: a loop over chunks in
  the TPU kernel body's order (``ssd.py:26-53``), batched over (b, h).
* :func:`ssd_chunk_parallel_model` — the kernel's decomposition in plain
  PyTorch (the segmented cum, the chunk states, the carry, the query and
  key tiles on and below the diagonal), to test the decomposition on the
  CPU against the reference.
* :func:`ssd_fused_bwd` — the backward: on CUDA tensors the
  :data:`LAUNCHES_PER_BWD` launches of ``csrc/ssd_bwd.cu`` (the local
  dY-C terms, the reverse state pass, the key-tile side, which computes
  each tile pair's C Bᵀ and dY Xᵀ once and hands the query side its M
  tiles, the query-tile side, the finish), fp32 products on the tensor
  cores (3xTF32), from the forward's cum and entering states; on CPU
  tensors, and only there, :func:`ssd_fused_bwd_ref`, the same chunk
  formulas in plain PyTorch.  :func:`ssd_fused` records a graph through
  an autograd Function whose backward is this, when grad is enabled and
  an input requires it; else it records nothing, as it did for serving.

Beyond the reference's ``ssd_fused`` all take an optional ``init_state``
(b, h, p, n), the contract of ``repro.models.ssm.ssd_chunked``, which the
model calls; with ``None`` the scan starts from zero, as ``ssd_fused`` does.
Accumulation is in promote(xd, float32), the carried state included: y
comes back in xd's dtype, the final state in the accumulation dtype.

The dtypes: all float32, all float64, or the reference model's SSD_BF16
mix (``repro.models.ssm``, ``ssm.py:214-217``): xd, B and C bfloat16, ad
(and ``init_state``) float32.  The bf16 form's kernels keep the fp32
form's arithmetic on the widened inputs and round y once, so on the card
its y is the fp32 form's on the upcast inputs rounded to bf16 and its
state the fp32 form's, exactly; its backward's dxd, dB and dC are the fp32
backward's rounded once, dad and d init_state float32.  No other mix is
taken (float16 included).
"""
from __future__ import annotations

import contextlib
import functools
import math

import torch

from repro_torch.analysis.preflight import plan_ssd_fused, plan_ssd_fused_bwd
from repro_torch.core.autotune import (
    SSD_BWD_LAUNCHES,
    SSD_LAUNCHES,
    SSD_SCAN_ROWS,
    SSD_TILE,
    ssd_bwd_bytes,
    ssd_bwd_flops,
    ssd_bwd_pairs,
    ssd_bytes,
    ssd_flops,
)
from repro_torch.kernels import abstract

__all__ = ["BWD_LAUNCHES", "KERNEL_LAUNCHES", "LAUNCHES_PER_BWD",
           "LAUNCHES_PER_CALL", "segsum", "ssd_chunk_parallel_model",
           "ssd_fused", "ssd_fused_bwd", "ssd_fused_bwd_ref", "ssd_fused_ref"]

#: Launches of kernel B8 by :func:`ssd_fused` in this process, on CUDA
#: tensors, counted where each launch is made and nowhere else:
#: :data:`LAUNCHES_PER_CALL` a call.
KERNEL_LAUNCHES = 0
#: Launches of one :func:`ssd_fused` call on the card.
LAUNCHES_PER_CALL = len(SSD_LAUNCHES)
#: Launches of the backward kernel by :func:`ssd_fused_bwd` in this
#: process, on CUDA tensors, counted where each launch is made:
#: :data:`LAUNCHES_PER_BWD` a call.
BWD_LAUNCHES = 0
#: Launches of one :func:`ssd_fused_bwd` call on the card.
LAUNCHES_PER_BWD = len(SSD_BWD_LAUNCHES)

_KERNEL_DTYPES = (torch.float32, torch.float64, torch.bfloat16)
#: The C entries' element-type codes (``csrc/ssd_mma.cuh``).
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}


def _check_args(xd, ad, B, C, init_state) -> tuple[int, int, int, int, int, int]:
    """Device, dtype and shape of one call; returns (b, l, h, p, g, n).
    The dtypes: one of float32 / float64 for all, or the bf16 mix (xd, B,
    C bfloat16; ad and init_state float32).  Chunking and group counts are
    the plan's job."""
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
        raise TypeError(f"xd dtype {xd.dtype} is not bfloat16, float32 or "
                        "float64")
    acc = _acc_dtype(xd.dtype)
    for name, t, want in (("ad", ad, acc), ("B", B, xd.dtype),
                          ("C", C, xd.dtype)):
        if t.dtype != want:
            raise TypeError(f"{name} dtype {t.dtype} != {want} (xd dtype "
                            f"{xd.dtype})")
        if t.device != xd.device:
            raise ValueError(f"{name} on {t.device}, xd on {xd.device}")
    if init_state is not None:
        if init_state.shape != (b, h, p, n):
            raise ValueError(f"init_state {tuple(init_state.shape)} != "
                             f"(b, h, p, n) = {(b, h, p, n)}")
        if xd.dtype == torch.bfloat16 and init_state.dtype != acc:
            raise TypeError(f"init_state dtype {init_state.dtype} != {acc} "
                            "(xd dtype bfloat16)")
        if init_state.device != xd.device:
            raise ValueError(f"init_state on {init_state.device}, xd on "
                             f"{xd.device}")
    return b, l, h, p, g, n


def _acc_dtype(dtype: torch.dtype) -> torch.dtype:
    return torch.promote_types(dtype, torch.float32)


@functools.lru_cache(maxsize=256)
def _plan(b: int, l: int, h: int, p: int, g: int, n: int, chunk: int,
          dtype: torch.dtype):
    """:func:`plan_ssd_fused` of one shape, built once: a prefill calls the
    scan once a layer with the same shape, and the plan is host work in
    front of the first launch."""
    return plan_ssd_fused(b, l, h, p, g, n, chunk=chunk,
                          dtype=str(dtype).removeprefix("torch."))


@functools.lru_cache(maxsize=256)
def _bwd_plan(b: int, l: int, h: int, p: int, g: int, n: int, chunk: int,
              dtype: torch.dtype):
    """:func:`plan_ssd_fused_bwd` of one shape, built once (a train step
    calls the backward once a layer with the same shape)."""
    return plan_ssd_fused_bwd(b, l, h, p, g, n, chunk=chunk,
                              dtype=str(dtype).removeprefix("torch."))


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
    _plan(b, l, h, p, g, n, chunk, xd.dtype).raise_if_invalid()
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


def _segmented_cum(ac: torch.Tensor) -> torch.Tensor:
    """The kernel's running sum over the last axis: segments of
    :data:`SSD_SCAN_ROWS` rows, each summed from its start, then the carry
    of the rows before it."""
    out, carry = [], torch.zeros_like(ac[..., 0])
    for j0 in range(0, ac.shape[-1], SSD_SCAN_ROWS):
        seg = torch.cumsum(ac[..., j0:j0 + SSD_SCAN_ROWS], dim=-1) \
            + carry[..., None]
        out.append(seg)
        carry = seg[..., -1]
    return torch.cat(out, dim=-1)


def ssd_chunk_parallel_model(xd: torch.Tensor, ad: torch.Tensor,
                             B: torch.Tensor, C: torch.Tensor, *,
                             chunk: int = 128,
                             init_state: torch.Tensor | None = None
                             ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel B8's decomposition in plain PyTorch, all chunks at once:
    launch 1's segmented cum and chunk states, launch 2's carry, launch 3's
    query tiles of :data:`SSD_TILE` rows over the key tiles on and below
    the diagonal, each C Bᵀ tile once.  Same contract as
    :func:`ssd_fused_ref`."""
    b, l, h, p, g, n = _check_args(xd, ad, B, C, init_state)
    _plan(b, l, h, p, g, n, chunk, xd.dtype).raise_if_invalid()
    acc = _acc_dtype(xd.dtype)
    q, nc = chunk, l // chunk
    grp = torch.arange(h, device=xd.device) // (h // g)

    def per_chunk(t, last):                   # (b, l, h, last) -> (b, h, nc, q, last)
        return t.to(acc).reshape(b, nc, q, h, last).permute(0, 3, 1, 2, 4)

    x = per_chunk(xd, p)
    bh, ch = (per_chunk(t[:, :, grp], n) for t in (B, C))
    cum = _segmented_cum(ad.to(acc).reshape(b, nc, q, h).permute(0, 3, 1, 2))
    # launch 1: each chunk's local state
    dec = torch.exp(cum[..., -1:] - cum)
    states = (x * dec[..., None]).transpose(-1, -2) @ bh       # (b, h, nc, p, n)
    # launch 2: the state entering each chunk, and the final state
    carried = (torch.zeros((b, h, p, n), dtype=acc, device=xd.device)
               if init_state is None else init_state.to(acc))
    entering = []
    for c in range(nc):
        entering.append(carried)
        carried = carried * torch.exp(cum[:, :, c, -1])[..., None, None] \
            + states[:, :, c]
    entering = torch.stack(entering, dim=2)
    # launch 3: query tiles, key tiles on and below the diagonal
    y = torch.empty_like(x)
    for i0 in range(0, q, SSD_TILE):
        rows = slice(i0, min(i0 + SSD_TILE, q))
        ci, cq = ch[..., rows, :], cum[..., rows]
        yi = torch.exp(cq)[..., None] * (ci @ entering.transpose(-1, -2))
        ii = torch.arange(rows.start, rows.stop, device=xd.device)[:, None]
        for j0 in range(0, i0 + 1, SSD_TILE):
            keys = slice(j0, min(j0 + SSD_TILE, q))
            jj = torch.arange(keys.start, keys.stop, device=xd.device)[None, :]
            diff = cq[..., :, None] - cum[..., None, keys]
            decay = torch.exp(torch.where(ii >= jj, diff, float("-inf")))
            gm = ci @ bh[..., keys, :].transpose(-1, -2)
            yi = yi + (gm * decay) @ x[..., keys, :]
        y[..., rows, :] = yi
    y = y.permute(0, 2, 3, 1, 4).reshape(b, l, h, p).to(xd.dtype)
    return y, carried


def _launch(xd, ad, B, C, init, y, fstate, chunk: int, keep: bool = False
            ) -> tuple[torch.Tensor, torch.Tensor]:
    """Kernel B8's three launches on PyTorch's current stream of xd's
    device, made with that device current; each is counted once it is
    made, and a refused one raises before the next is tried.  The scratch
    (cum (b, h, l), the chunk states and the states entering each chunk,
    (b, h, l / chunk, p, n) each) is allocated here and cum and the
    entering states are returned when ``keep`` (the backward saves them),
    in a block of their own, so that the chunk states are freed after the
    call; without it (serving) the three share one block, passed to the
    launches as raw pointers, and nothing is returned (None, None).  The
    bf16 form's y partial sums (``yacc``, float32) are allocated here
    where p takes more than one 64-column slice.  Fake tensors (the dry
    run: :mod:`repro_torch.kernels.abstract`) stop after the allocations:
    the work is charged and nothing is launched."""
    global KERNEL_LAUNCHES
    from repro_torch.kernels import cuda_lib

    b, l, h, p = xd.shape
    g, n = B.shape[2], B.shape[3]
    nc = l // chunk
    n_cum = -(-b * h * l // 4) * 4            # the states start 16 B aligned
    n_st = b * h * nc * p * n
    kept = torch.empty(n_cum + (1 if keep else 2) * n_st, dtype=fstate.dtype,
                       device=xd.device)
    states = (torch.empty(n_st, dtype=fstate.dtype, device=xd.device)
              if keep else None)
    yacc = (torch.empty((b, l, h, p), dtype=fstate.dtype, device=xd.device)
            if xd.dtype == torch.bfloat16 and p > SSD_TILE else None)

    def kept_views():
        if not keep:
            return None, None
        return (kept[:b * h * l].view(b, h, l),
                kept[n_cum:n_cum + n_st].view(b, h, nc, p, n))

    if abstract.is_fake(xd, ad, B, C, init):
        abstract.charge("ssd_fused", xd.device, ssd_flops(b, l, h, p, n, chunk),
                        ssd_bytes(b, l, h, p, g, n, xd.element_size(),
                                  fstate.element_size(), init is not None))
        return kept_views()
    lib = cuda_lib.library("ssd_fused")
    code = _DTYPE_CODE[xd.dtype]
    base, item = kept.data_ptr(), kept.element_size()
    cum, entering = base, base + n_cum * item
    st = states.data_ptr() if keep else base + (n_cum + n_st) * item
    x_, b_ = xd.data_ptr(), B.data_ptr()
    y_, f_ = y.data_ptr(), fstate.data_ptr()
    init_ = None if init is None else init.data_ptr()
    yacc_ = None if yacc is None else yacc.data_ptr()
    index = xd.device.index
    stream = torch.cuda.current_stream(index).cuda_stream
    calls = {
        "chunk_state": lambda: lib.repro_ssd_chunk_state(
            x_, ad.data_ptr(), b_, cum, st, b, l, h, p, g, n, chunk, code,
            stream),
        "state_pass": lambda: lib.repro_ssd_state_pass(
            st, entering, cum, init_, f_, b, l, h, p, n, chunk, code, stream),
        "chunk_output": lambda: lib.repro_ssd_chunk_output(
            x_, b_, C.data_ptr(), cum, entering, int(init is not None), y_,
            yacc_, b, l, h, p, g, n, chunk, code, stream),
    }
    with (contextlib.nullcontext() if index == torch.cuda.current_device()
          else torch.cuda.device(index)):
        for launch in SSD_LAUNCHES:
            err = calls[launch]()
            if err != 0:
                msg = lib.repro_ssd_cuda_error_string(err).decode()
                raise RuntimeError(
                    f"ssd_fused {launch} launch failed (cudaError {err}: "
                    f"{msg}) for (b, l, h, p, g, n) = {(b, l, h, p, g, n)}, "
                    f"chunk {chunk}")
            KERNEL_LAUNCHES += 1
    return kept_views()


def _forward(xd, ad, B, C, chunk: int, init_state, keep: bool, dims=None):
    """The scan of checked arguments: (y, final state) and, on the card,
    the forward's cum and entering states (for the backward when ``keep``;
    None on the CPU).  Fake tensors on any device take the card's path up
    to :func:`_launch`.  ``dims``: :func:`_check_args`' result, when the
    caller has it."""
    b, l, h, p, g, n = dims or _check_args(xd, ad, B, C, init_state)
    fake = abstract.is_fake(xd, ad, B, C, init_state)
    if xd.device.type == "cpu" and not fake:
        y, fstate = ssd_fused_ref(xd, ad, B, C, chunk=chunk,
                                  init_state=init_state)
        return y, fstate, None, None
    if xd.device.type != "cuda" and not fake:
        raise RuntimeError(
            f"ssd_fused has a CUDA kernel and a CPU reference; got {xd.device}")
    _plan(b, l, h, p, g, n, chunk, xd.dtype).raise_if_invalid()
    xd, ad, B, C = (t if t.is_contiguous() else t.contiguous()
                    for t in (xd, ad, B, C))
    acc = _acc_dtype(xd.dtype)
    init = None if init_state is None else init_state.to(acc).contiguous()
    y = torch.empty_like(xd)
    fstate = torch.empty((b, h, p, n), dtype=acc, device=xd.device)
    cum, entering = _launch(xd, ad, B, C, init, y, fstate, chunk, keep)
    return y, fstate, cum, entering


class _SSDFused(torch.autograd.Function):
    """:func:`ssd_fused` with a gradient: the forward's launches (or its
    plain version on the CPU), then :func:`ssd_fused_bwd`'s, which read the
    forward's cum and entering states (saved, not recomputed: at mamba2's
    (2, 512) 10.5 MB a layer in fp32)."""

    @staticmethod
    def forward(ctx, xd, ad, B, C, init_state, chunk):
        y, fstate, cum, entering = _forward(xd, ad, B, C, chunk, init_state,
                                            keep=True)
        ctx.chunk = chunk
        ctx.set_materialize_grads(False)
        ctx.save_for_backward(xd, ad, B, C, init_state, fstate, cum, entering)
        return y, fstate

    @staticmethod
    def backward(ctx, dy, dfinal):
        xd, ad, B, C, init_state, fstate, cum, entering = ctx.saved_tensors
        if dy is None:
            dy = torch.zeros_like(xd)
        dxd, dad, dB, dC, dinit = ssd_fused_bwd(
            xd, ad, B, C, dy, dfinal, chunk=ctx.chunk, init_state=init_state,
            saved=(fstate, cum, entering))
        return (dxd, dad, dB, dC,
                dinit if ctx.needs_input_grad[4] else None, None)


def ssd_fused(xd: torch.Tensor, ad: torch.Tensor, B: torch.Tensor,
              C: torch.Tensor, *, chunk: int = 128,
              init_state: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused scan.  xd (b, l, h, p) (inputs pre-multiplied by dt), ad
    (b, l, h), B and C (b, l, g, n), all float32, all float64, or xd, B
    and C bfloat16 beside float32 ad (and ``init_state``); l a multiple of
    ``chunk``.  Returns (y (b, l, h, p), final state
    (b, h, p, n)).  On a CUDA device the :data:`LAUNCHES_PER_CALL` launches
    of kernel B8; on the CPU the plain :func:`ssd_fused_ref`.  Where grad
    is enabled and an input requires it, the result carries a graph whose
    backward is :func:`ssd_fused_bwd`.
    """
    dims = _check_args(xd, ad, B, C, init_state)
    if torch.is_grad_enabled() and (
            xd.requires_grad or ad.requires_grad or B.requires_grad
            or C.requires_grad
            or (init_state is not None and init_state.requires_grad)):
        return _SSDFused.apply(xd, ad, B, C, init_state, chunk)
    y, fstate, _, _ = _forward(xd, ad, B, C, chunk, init_state, keep=False,
                               dims=dims)
    return y, fstate


# ---------------------------------------------------------------------------
# The backward
# ---------------------------------------------------------------------------


def ssd_fused_bwd_ref(xd: torch.Tensor, ad: torch.Tensor, B: torch.Tensor,
                      C: torch.Tensor, dy: torch.Tensor,
                      dfinal: torch.Tensor | None = None, *, chunk: int = 128,
                      init_state: torch.Tensor | None = None):
    """The backward of :func:`ssd_fused_ref` in plain PyTorch, by the chunk
    formulas the kernel computes (``csrc/ssd_bwd.cu``), all chunks at once:
    the forward's cum and entering states (recomputed here), each chunk's
    local term ``Σ_i e^{cum_i} dY_iᵀ C_i``, the reverse pass over the
    chunks for the gradient of each chunk's leaving state dS_out, then
    ``M = (dY Xᵀ) ∘ L``, ``dX = (G ∘ L)ᵀ dY + diag(e^{cum_last - cum}) B
    dS_outᵀ``, ``dC = M B + diag(e^{cum}) dY S_in``, ``dB = Mᵀ C +
    diag(e^{cum_last - cum}) X dS_out``, dcum and its reverse running sum
    dad; dB and dC summed over the heads of a group in ascending order.
    ``dfinal`` is the final state's gradient (None: zero).  Returns (dxd,
    dad, dB, dC, d init_state (b, h, p, n) in the accumulation dtype, the
    gradient of the zero state without one)."""
    b, l, h, p, g, n = _check_args(xd, ad, B, C, init_state)
    _plan(b, l, h, p, g, n, chunk, xd.dtype).raise_if_invalid()
    acc = _acc_dtype(xd.dtype)
    q, nc, hg = chunk, l // chunk, h // g
    grp = torch.arange(h, device=xd.device) // hg

    def per_chunk(t, last):                   # (b, l, h, last) -> (b, h, nc, q, last)
        return t.to(acc).reshape(b, nc, q, h, last).permute(0, 3, 1, 2, 4)

    def back(t, last):                        # the inverse of per_chunk
        return t.permute(0, 2, 3, 1, 4).reshape(b, l, h, last)

    x = per_chunk(xd, p)
    bh, ch = (per_chunk(t[:, :, grp], n) for t in (B, C))
    dyc = per_chunk(dy, p)
    a = ad.to(acc).reshape(b, nc, q, h).permute(0, 3, 1, 2)     # (b, h, nc, q)
    cum = torch.cumsum(a, dim=-1)
    last = cum[..., -1]
    dec_end = torch.exp(last[..., None] - cum)
    zeros = torch.zeros((b, h, p, n), dtype=acc, device=xd.device)
    # the forward's states: entering each chunk (S_in) and leaving it
    carried = zeros if init_state is None else init_state.to(acc)
    s_in = []
    for c in range(nc):
        s_in.append(carried)
        carried = carried * torch.exp(last[:, :, c])[..., None, None] \
            + (x[:, :, c] * dec_end[:, :, c, :, None]).transpose(-1, -2) \
            @ bh[:, :, c]
    s_out = torch.stack(s_in[1:] + [carried], dim=2)
    s_in = torch.stack(s_in, dim=2)
    # launch 1: local terms; launch 2: the reverse pass
    local = (dyc * torch.exp(cum)[..., None]).transpose(-1, -2) @ ch
    run = zeros if dfinal is None else dfinal.to(acc)
    d_out = []
    for c in reversed(range(nc)):
        d_out.append(run)
        run = run * torch.exp(last[:, :, c])[..., None, None] + local[:, :, c]
    d_out = torch.stack(d_out[::-1], dim=2)
    # launches 3 and 4: the chunk formulas
    lmat = torch.exp(segsum(a))
    gm = ch @ bh.transpose(-1, -2)
    m = (dyc @ x.transpose(-1, -2)) * lmat
    x_dso = x @ d_out                                           # (.., q, n)
    dx = (gm * lmat).transpose(-1, -2) @ dyc \
        + dec_end[..., None] * (bh @ d_out.transpose(-1, -2))
    dc = m @ bh + torch.exp(cum)[..., None] * (dyc @ s_in)
    db = m.transpose(-1, -2) @ ch + dec_end[..., None] * x_dso
    pm = gm * m
    y_inter = torch.exp(cum)[..., None] * (ch @ s_in.transpose(-1, -2))
    dcum = pm.sum(-1) - pm.sum(-2) + (dyc * y_inter).sum(-1) \
        - dec_end * (x_dso * bh).sum(-1)
    dcum[..., -1] += (d_out * s_out).sum((-1, -2))
    # launch 5: dad, the group sums
    dad = torch.flip(torch.cumsum(torch.flip(dcum, [-1]), -1), [-1])
    dad = dad.permute(0, 2, 3, 1).reshape(b, l, h)

    def group_sum(t):
        t = back(t, n).reshape(b, l, g, hg, n)
        out = t[:, :, :, 0]
        for k in range(1, hg):
            out = out + t[:, :, :, k]
        return out

    return (back(dx, p).to(xd.dtype), dad.to(ad.dtype),
            group_sum(db).to(B.dtype), group_sum(dc).to(C.dtype), run)


class _BwdBuffers:
    """The backward's outputs and scratch on xd's device: dx, dB, dC in
    xd's dtype, dad and dinit (None without an initial state) in the
    accumulation dtype, as is the scratch: the local terms and dS_out
    (b, h, nc, p, n), the per-head dB and dC (b, l, h, n), dcum's two parts
    (b, h, l), the key launch's M and (G ∘ L) tiles ((b h nc, pairs, 64,
    64) each, a pair for each query tile I and key tile J <= I of a chunk)
    and the pairs' row sums (b h nc, pairs, 64); the M tiles and the row
    sums are handed to the query launch.  The scratch is one allocation cut
    at 16 B aligned offsets, passed to the launches as raw pointers
    (``ptr``; host work in front of the first launch is time the card
    waits); ``buf[name]`` makes any of it a view."""

    def __init__(self, xd, B, init, chunk: int):
        b, l, h, p = xd.shape
        g, n = B.shape[2], B.shape[3]

        acc = _acc_dtype(xd.dtype)
        self.outputs = (torch.empty_like(xd),
                        xd.new_empty((b, l, h), dtype=acc),
                        xd.new_empty((b, l, g, n)), xd.new_empty((b, l, g, n)),
                        None if init is None
                        else xd.new_empty((b, h, p, n), dtype=acc))
        self._at, total = _bwd_scratch_layout(b, l, h, p, g, n, chunk)
        self._block = xd.new_empty((total,), dtype=acc)
        if abstract.is_fake(self._block):
            return                            # no storage: no pointers
        base, item = self._block.data_ptr(), self._block.element_size()
        self.ptr = {k: base + at * item for k, (at, _) in self._at.items()}
        for k, t in zip(("dx", "dad", "dB", "dC", "dinit"), self.outputs):
            self.ptr[k] = None if t is None else t.data_ptr()

    def __getitem__(self, name: str) -> torch.Tensor:
        outs = dict(zip(("dx", "dad", "dB", "dC", "dinit"), self.outputs))
        if name in outs:
            return outs[name]
        at, shape = self._at[name]
        return self._block[at:at + math.prod(shape)].view(shape)


@functools.lru_cache(maxsize=64)
def _bwd_scratch_layout(b: int, l: int, h: int, p: int, g: int, n: int,
                        chunk: int) -> tuple[dict, int]:
    """The backward's scratch, cut at 16 B aligned offsets of one block:
    ({name: (offset, shape)}, elements), built once a shape."""
    nc = l // chunk
    pairs = b * h * nc * ssd_bwd_pairs(l, chunk)
    shapes = {"local": (b, h, nc, p, n), "dso": (b, h, nc, p, n),
              "dbh": (b, l, h, n), "dch": (b, l, h, n), "dcq": (b, h, l),
              "dck": (b, h, l), "mh": (pairs, SSD_TILE, SSD_TILE),
              "gh": (pairs, SSD_TILE, SSD_TILE), "rh": (pairs, SSD_TILE)}
    at, total = {}, 0
    for k, shape in shapes.items():
        at[k] = (total, shape)
        total += -(-math.prod(shape) // 4) * 4
    return at, total


def _bwd_calls(lib, xd, B, C, dy, dfinal, init, fstate, cum, entering,
               chunk: int, buf: _BwdBuffers, stream: int) -> dict:
    """One closure per backward launch, by :data:`SSD_BWD_LAUNCHES` name,
    each making its launch through its own C entry point and returning the
    cudaError code.  :func:`_launch_bwd` runs them in order; counting is
    its own, so ``scripts/ssd_launch_times.py`` and the tests may call one
    alone to time it or to inspect what it hands on."""
    b, l, h, p = xd.shape
    g, n = B.shape[2], B.shape[3]
    code = _DTYPE_CODE[xd.dtype]
    o = buf.ptr
    x_, dy_, b_, c_ = xd.data_ptr(), dy.data_ptr(), B.data_ptr(), C.data_ptr()
    cum_, ent_ = cum.data_ptr(), entering.data_ptr()
    df_ = None if dfinal is None else dfinal.data_ptr()
    return {
        "bwd_local": lambda: lib.repro_ssd_bwd_local(
            dy_, c_, cum_, o["local"], b, l, h, p, g, n, chunk, code, stream),
        "bwd_state_pass": lambda: lib.repro_ssd_bwd_state_pass(
            o["local"], o["dso"], cum_, df_, o["dinit"], b, l, h, p, n, chunk,
            code, stream),
        "bwd_key": lambda: lib.repro_ssd_bwd_key(
            x_, dy_, b_, c_, cum_, ent_, fstate.data_ptr(), o["dso"],
            int(dfinal is not None), o["dbh"], o["dx"], o["dck"], o["mh"],
            o["gh"], o["rh"], b, l, h, p, g, n, chunk, code, stream),
        "bwd_query": lambda: lib.repro_ssd_bwd_query(
            dy_, b_, c_, cum_, ent_, int(init is not None), o["mh"], o["rh"],
            o["dch"], o["dcq"], b, l, h, p, g, n, chunk, code, stream),
        "bwd_finish": lambda: lib.repro_ssd_bwd_finish(
            o["dcq"], o["dck"], o["dad"], o["dbh"], o["dch"], o["dB"],
            o["dC"], b, l, h, g, n, chunk, code, stream),
    }


def _launch_bwd(xd, B, C, dy, dfinal, init, fstate, cum, entering,
                chunk: int):
    """The backward kernel's :data:`LAUNCHES_PER_BWD` launches on PyTorch's
    current stream of xd's device, made with that device current, in
    :data:`SSD_BWD_LAUNCHES` order through :func:`_bwd_calls`; each is
    counted once it is made, and a refused one raises, naming it, before
    the next is tried.  Returns (dxd, dad, dB, dC, dinit or None); outputs
    and scratch are allocated here (:class:`_BwdBuffers`).  Fake tensors
    stop after the allocations: the work is charged, nothing launched."""
    global BWD_LAUNCHES
    from repro_torch.kernels import cuda_lib

    buf = _BwdBuffers(xd, B, init, chunk)
    if abstract.is_fake(xd, B, C, dy, dfinal, init, fstate, cum, entering):
        b, l, h, p = xd.shape
        g, n = B.shape[2], B.shape[3]
        abstract.charge("ssd_fused_bwd", xd.device,
                        ssd_bwd_flops(b, l, h, p, n, chunk),
                        ssd_bwd_bytes(b, l, h, p, g, n, chunk,
                                      xd.element_size(),
                                      buf._block.element_size()))
        return buf.outputs
    lib = cuda_lib.library("ssd_bwd")
    index = xd.device.index
    calls = _bwd_calls(lib, xd, B, C, dy, dfinal, init, fstate, cum,
                       entering, chunk, buf,
                       torch.cuda.current_stream(index).cuda_stream)
    with (contextlib.nullcontext() if index == torch.cuda.current_device()
          else torch.cuda.device(index)):
        for name in SSD_BWD_LAUNCHES:
            err = calls[name]()
            if err != 0:
                b, l, h, p = xd.shape
                msg = lib.repro_ssd_bwd_cuda_error_string(err).decode()
                raise RuntimeError(
                    f"ssd_fused_bwd {name} launch failed (cudaError {err}: "
                    f"{msg}) for (b, l, h, p, g, n) = "
                    f"{(b, l, h, p) + tuple(B.shape[2:])}, chunk {chunk}")
            BWD_LAUNCHES += 1
    return buf.outputs


def ssd_fused_bwd(xd: torch.Tensor, ad: torch.Tensor, B: torch.Tensor,
                  C: torch.Tensor, dy: torch.Tensor,
                  dfinal: torch.Tensor | None = None, *, chunk: int = 128,
                  init_state: torch.Tensor | None = None, saved=None):
    """Gradients of :func:`ssd_fused`'s (y, final state) with respect to
    (xd, ad, B, C, init_state), given dy (b, l, h, p) and ``dfinal``
    (b, h, p, n; None: zero).  On CUDA tensors the
    :data:`LAUNCHES_PER_BWD` launches of ``csrc/ssd_bwd.cu``, or raises; on
    CPU tensors :func:`ssd_fused_bwd_ref`; fake tensors on any device take
    the card's path up to :func:`_launch_bwd`.  ``saved`` is the forward's
    (final state, cum, entering states) from its launches; without it the
    forward's launches run first to make them.  Returns (dxd, dad, dB, dC,
    d init_state or None) in the inputs' dtype."""
    b, l, h, p, g, n = _check_args(xd, ad, B, C, init_state)
    if dy.shape != xd.shape or dy.device != xd.device:
        raise ValueError(f"dy {tuple(dy.shape)} on {dy.device} is not xd's "
                         f"{tuple(xd.shape)} on {xd.device}")
    fake = abstract.is_fake(xd, ad, B, C, dy, dfinal, init_state)
    if xd.device.type == "cpu" and not fake:
        dxd, dad, dB, dC, dinit = ssd_fused_bwd_ref(
            xd, ad, B, C, dy, dfinal, chunk=chunk, init_state=init_state)
        return dxd, dad, dB, dC, None if init_state is None else dinit
    if xd.device.type != "cuda" and not fake:
        raise RuntimeError(f"ssd_fused_bwd has a CUDA kernel and a CPU "
                           f"reference; got {xd.device}")
    _bwd_plan(b, l, h, p, g, n, chunk, xd.dtype).raise_if_invalid()
    acc = _acc_dtype(xd.dtype)
    xd, B, C = (t if t.is_contiguous() else t.contiguous() for t in (xd, B, C))
    init = None if init_state is None else init_state.to(acc).contiguous()
    if saved is None:
        _, fstate, cum, entering = _forward(xd, ad, B, C, chunk, init,
                                            keep=True)
    else:
        fstate, cum, entering = saved
    if dy.dtype != xd.dtype or not dy.is_contiguous():
        dy = dy.to(xd.dtype).contiguous()
    dfinal = None if dfinal is None else dfinal.to(acc).contiguous()
    return _launch_bwd(xd, B, C, dy, dfinal, init, fstate, cum, entering,
                       chunk)

