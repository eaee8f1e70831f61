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

Beyond the reference's ``ssd_fused`` all take an optional ``init_state``
(b, h, p, n), the contract of ``repro.models.ssm.ssd_chunked``, which the
model calls; with ``None`` the scan starts from zero, as ``ssd_fused`` does.
Accumulation is in promote(xd, float32), the carried state included: y
comes back in xd's dtype, the final state in the accumulation dtype.
"""
from __future__ import annotations

import functools

import torch

from repro_torch.analysis.preflight import plan_ssd_fused
from repro_torch.core.autotune import SSD_LAUNCHES, SSD_SCAN_ROWS, SSD_TILE

__all__ = ["KERNEL_LAUNCHES", "LAUNCHES_PER_CALL", "segsum",
           "ssd_chunk_parallel_model", "ssd_fused", "ssd_fused_ref"]

#: Launches of kernel B8 by :func:`ssd_fused` in this process, on CUDA
#: tensors, counted where each launch is made and nowhere else:
#: :data:`LAUNCHES_PER_CALL` a call.
KERNEL_LAUNCHES = 0
#: Launches of one :func:`ssd_fused` call on the card.
LAUNCHES_PER_CALL = len(SSD_LAUNCHES)

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


@functools.lru_cache(maxsize=256)
def _plan(b: int, l: int, h: int, p: int, g: int, n: int, chunk: int,
          dtype: torch.dtype):
    """:func:`plan_ssd_fused` of one shape, built once: a prefill calls the
    scan once a layer with the same shape, and the plan is host work in
    front of the first launch."""
    return plan_ssd_fused(b, l, h, p, g, n, chunk=chunk,
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


def _launch(xd, ad, B, C, init, y, fstate, chunk: int) -> None:
    """Kernel B8's three launches on PyTorch's current stream of xd's
    device, made with that device current; each is counted once it is
    made, and a refused one raises before the next is tried.  The scratch
    (cum (b, h, l), the chunk states and the states entering each chunk,
    (b, h, l / chunk, p, n) each) is allocated here, in one block."""
    global KERNEL_LAUNCHES
    from repro_torch.kernels import cuda_lib

    lib = cuda_lib.library("ssd_fused")
    b, l, h, p = xd.shape
    g, n = B.shape[2], B.shape[3]
    dbl = int(xd.dtype == torch.float64)
    nc = l // chunk
    n_cum = -(-b * h * l // 4) * 4            # the states start 16 B aligned
    n_st = b * h * nc * p * n
    scratch = torch.empty(n_cum + 2 * n_st, dtype=fstate.dtype,
                          device=xd.device)
    cum = scratch[:b * h * l].view(b, h, l)
    states = scratch[n_cum:n_cum + n_st].view(b, h, nc, p, n)
    entering = scratch[n_cum + n_st:].view(b, h, nc, p, n)
    with torch.cuda.device(xd.device):
        stream = torch.cuda.current_stream().cuda_stream
        calls = {
            "chunk_state": lambda: lib.repro_ssd_chunk_state(
                xd.data_ptr(), ad.data_ptr(), B.data_ptr(), cum.data_ptr(),
                states.data_ptr(), b, l, h, p, g, n, chunk, dbl, stream),
            "state_pass": lambda: lib.repro_ssd_state_pass(
                states.data_ptr(), entering.data_ptr(), cum.data_ptr(),
                None if init is None else init.data_ptr(), fstate.data_ptr(),
                b, l, h, p, n, chunk, dbl, stream),
            "chunk_output": lambda: lib.repro_ssd_chunk_output(
                xd.data_ptr(), B.data_ptr(), C.data_ptr(), cum.data_ptr(),
                entering.data_ptr(), int(init is not None), y.data_ptr(), b, l,
                h, p, g, n, chunk, dbl, stream),
        }
        for launch in SSD_LAUNCHES:
            err = calls[launch]()
            if err != 0:
                msg = lib.repro_ssd_cuda_error_string(err).decode()
                raise RuntimeError(
                    f"ssd_fused {launch} launch failed (cudaError {err}: "
                    f"{msg}) for (b, l, h, p, g, n) = {(b, l, h, p, g, n)}, "
                    f"chunk {chunk}")
            KERNEL_LAUNCHES += 1


def ssd_fused(xd: torch.Tensor, ad: torch.Tensor, B: torch.Tensor,
              C: torch.Tensor, *, chunk: int = 128,
              init_state: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Fused scan.  xd (b, l, h, p) (inputs pre-multiplied by dt), ad
    (b, l, h), B and C (b, l, g, n), all float32 or all float64; l a
    multiple of ``chunk``.  Returns (y (b, l, h, p), final state
    (b, h, p, n)).  On a CUDA device the :data:`LAUNCHES_PER_CALL` launches
    of kernel B8; on the CPU the plain :func:`ssd_fused_ref`.
    """
    b, l, h, p, g, n = _check_args(xd, ad, B, C, init_state)
    if xd.device.type == "cpu":
        return ssd_fused_ref(xd, ad, B, C, chunk=chunk, init_state=init_state)
    if xd.device.type != "cuda":
        raise RuntimeError(
            f"ssd_fused has a CUDA kernel and a CPU reference; got {xd.device}")
    _plan(b, l, h, p, g, n, chunk, xd.dtype).raise_if_invalid()
    xd, ad, B, C = (t.contiguous() for t in (xd, ad, B, C))
    acc = _acc_dtype(xd.dtype)
    init = None if init_state is None else init_state.to(acc).contiguous()
    y = torch.empty_like(xd)
    fstate = torch.empty((b, h, p, n), dtype=acc, device=xd.device)
    _launch(xd, ad, B, C, init, y, fstate, chunk)
    return y, fstate
