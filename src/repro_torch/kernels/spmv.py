"""ELLPACK SpMV and SpMM on Hopper: the paper's baseline format (kernel B6).

Port of ``repro.kernels.spmv`` (and of ``repro.kernels.ref.spmv_ref``).
The matrix is uniform-width ELLPACK in the slice-transposed layout
(S, W, C): element (s, w, c) is the w-th nonzero of row ``s*C + c``, PAD
(-1) columns are masked.  y has ``S * C`` entries; callers trim it to
``n_rows``.

* :func:`spmv_ell` — the wrapper for one column.  On CUDA tensors it
  launches the hand-written kernel ``csrc/spmv_ell.cu`` (one thread per
  row, the width walked in registers up to its warp's live width) or
  raises; on CPU tensors, and only there, it runs :func:`spmv_ell_ref`.
* :func:`spmm_ell` — the wrapper for k columns, X (n_cols, k): one launch
  of the kernel's k-column form a k tile (a group of lanes a row, 16 B of
  columns a lane), bit-equal to k launches of :func:`spmv_ell`; on CPU
  tensors :func:`spmm_ell_ref`.
* :func:`live_widths` — each warp's live width, the bound of the kernel's
  walk, computed from ``cols`` with torch ops on ``cols``' device;
  :func:`cut_to_live` — the slab as a walk to handed-in widths reads it
  (each bounded to ``[0, W]``, in the kernel as here).
* :func:`spmv_ell_ref` / :func:`spmm_ell_ref` — the plain PyTorch versions
  of the same functions.
"""
from __future__ import annotations

import torch

from repro_torch.core.autotune import (
    ELL_BLOCK_THREADS,
    ELL_LIVE_ROWS,
    ell_k_tiles,
    ell_vec,
)
from repro_torch.sparse.formats import PAD

__all__ = ["KERNEL_LAUNCHES", "SPMM_LAUNCHES", "cut_to_live", "live_widths",
           "spmm_ell", "spmm_ell_ref", "spmv_ell", "spmv_ell_ref"]

#: Launches of kernel B6 by :func:`spmv_ell` and :func:`spmm_ell` in this
#: process: one per call of the one-column form, one per k tile of the
#: k-column form, on CUDA tensors, counted where the kernel is launched
#: and nowhere else.
KERNEL_LAUNCHES = 0
#: The k-column form's share of :data:`KERNEL_LAUNCHES`.
SPMM_LAUNCHES = 0

_KERNEL_DTYPES = (torch.float32, torch.float64)


def _check_slab(cols, vals, x) -> None:
    """Device, dtype, shape and contiguity of the slab and of x's type.
    Column bounds are the preflight's job
    (:func:`repro_torch.analysis.preflight.plan_spmv_ell`)."""
    if cols.ndim != 3 or vals.shape != cols.shape:
        raise ValueError(f"cols {tuple(cols.shape)} / vals {tuple(vals.shape)}"
                         " are not one (S, W, C) slab")
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


def _check_args(cols, vals, x) -> None:
    if x.ndim != 1:
        raise ValueError(f"x must be (n_cols,), got shape {tuple(x.shape)}")
    _check_slab(cols, vals, x)


def _check_live(cols, live) -> None:
    """The live-width array's dtype, device, shape and contiguity.  Its
    values may be anything: the walk bounds each to ``[0, W]``
    (:func:`cut_to_live`)."""
    n_slices, _, c = cols.shape
    want = (-(-n_slices * c // ELL_LIVE_ROWS),)
    if live.dtype != torch.int32:
        raise TypeError(f"live widths must be int32, got {live.dtype}")
    if tuple(live.shape) != want:
        raise ValueError(f"live widths of shape {tuple(live.shape)}, want "
                         f"{want} (one per {ELL_LIVE_ROWS} rows)")
    if live.device != cols.device or not live.is_contiguous():
        raise ValueError(f"live widths on {live.device} (contiguous "
                         f"{live.is_contiguous()}), cols on {cols.device}")


def live_widths(cols: torch.Tensor) -> torch.Tensor:
    """Each warp's live width of an (S, W, C) column slab: entry i is 1 +
    the last slot w at which any of the rows ``32 i .. 32 i + 31`` (row r
    is lane ``r % C`` of slice ``r // C``) stores a non-PAD column, 0 if
    none does.  PAD may stand anywhere in a row.  Computed with torch ops
    on ``cols``' device (one pass a slot); returns int32 of shape
    (ceil(S * C / 32),)."""
    if cols.ndim != 3 or cols.dtype != torch.int32:
        raise ValueError(f"cols must be one int32 (S, W, C) slab, got "
                         f"{tuple(cols.shape)} {cols.dtype}")
    n_slices, width, c = cols.shape
    row = torch.zeros((n_slices, c), dtype=torch.int32, device=cols.device)
    for w in range(width):
        row = torch.where(cols[:, w, :] != PAD, w + 1, row)
    flat = row.reshape(-1)
    groups = -(-flat.numel() // ELL_LIVE_ROWS)
    short = groups * ELL_LIVE_ROWS - flat.numel()
    if short:
        flat = torch.cat([flat, flat.new_zeros(short)])
    return flat.view(groups, ELL_LIVE_ROWS).amax(dim=1).to(
        torch.int32).contiguous()


def cut_to_live(cols: torch.Tensor, live: torch.Tensor) -> torch.Tensor:
    """``cols`` (S, W, C) with every slot the kernel's walk does not reach
    set to PAD: row r walks slots ``w < clamp(live[r // 32], 0, W)``.  A
    width past the warp's true one reaches only PAD slots more, so the
    result is unchanged; a negative one reaches none.  The kernel bounds
    the widths it reads the same way, so no walk leaves the slab."""
    n_slices, width, c = cols.shape
    bound = live.clamp(0, width).repeat_interleave(ELL_LIVE_ROWS)
    bound = bound[:n_slices * c].view(n_slices, 1, c)
    w = torch.arange(width, device=cols.device).view(1, width, 1)
    return torch.where(w < bound, cols, PAD)


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


def _check_rhs(cols, vals, X) -> None:
    if X.ndim != 2:
        raise ValueError(f"X must be (n_cols, k), got shape {tuple(X.shape)}")
    _check_slab(cols, vals, X)


def spmm_ell_ref(cols: torch.Tensor, vals: torch.Tensor,
                 X: torch.Tensor) -> torch.Tensor:
    """Y = A @ X for X (n_cols, k) in plain PyTorch: every output column is
    :func:`spmv_ell_ref` of that column of X (the same products, added in
    ascending w).  Returns Y of shape (S * C, k)."""
    _check_rhs(cols, vals, X)
    n_slices, width, c = cols.shape
    acc = torch.zeros((n_slices, c, X.shape[1]), dtype=X.dtype,
                      device=X.device)
    for w in range(width):
        col = cols[:, w, :]
        mask = (col != PAD)[..., None]
        acc += torch.where(mask, vals[:, w, :, None]
                           * X[torch.where(col != PAD, col, 0).long()], 0)
    return acc.reshape(-1, X.shape[1])


def _raise(lib, err: int, what: str, cols) -> None:
    msg = lib.repro_spmv_ell_cuda_error_string(err).decode()
    raise RuntimeError(f"{what} kernel launch failed (cudaError {err}: {msg}) "
                       f"for a {tuple(cols.shape)} slab")


def _launch(cols, vals, x, y, live) -> None:
    """One launch of kernel B6 at one column (one thread a row) on
    PyTorch's current stream of x's device, made with that device
    current."""
    global KERNEL_LAUNCHES
    from repro_torch.kernels import cuda_lib

    lib = cuda_lib.library("spmv_ell")
    n_slices, width, c = cols.shape
    with torch.cuda.device(x.device):
        err = lib.repro_spmv_ell(
            cols.data_ptr(), vals.data_ptr(), x.data_ptr(), y.data_ptr(),
            live.data_ptr(), n_slices, width, c, ELL_BLOCK_THREADS,
            int(x.dtype == torch.float64),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        _raise(lib, err, "spmv_ell", cols)
    KERNEL_LAUNCHES += 1


def _launch_tile(cols, vals, X, Y, live, k0: int, kt: int, group: int,
                 vec: int) -> None:
    """One launch of kernel B6's k-column form: columns [k0, k0 + kt) of X
    into Y, groups of ``group`` lanes a row, ``vec`` columns a lane."""
    global KERNEL_LAUNCHES, SPMM_LAUNCHES
    from repro_torch.kernels import cuda_lib

    lib = cuda_lib.library("spmv_ell")
    n_slices, width, c = cols.shape
    with torch.cuda.device(X.device):
        err = lib.repro_spmm_ell(
            cols.data_ptr(), vals.data_ptr(), X.data_ptr(), Y.data_ptr(),
            live.data_ptr(), n_slices, width, c, X.shape[1], k0, kt, group,
            vec, ELL_BLOCK_THREADS, int(X.dtype == torch.float64),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        _raise(lib, err, "spmm_ell", cols)
    KERNEL_LAUNCHES += 1
    SPMM_LAUNCHES += 1


def _on_card(t: torch.Tensor, name: str) -> bool:
    if t.device.type == "cpu":
        return False
    if t.device.type != "cuda":
        raise RuntimeError(
            f"{name} has a CUDA kernel and a CPU reference; got {t.device}")
    return True


def spmv_ell(cols: torch.Tensor, vals: torch.Tensor, x: torch.Tensor, *,
             w_block: int = 8,
             live_width: torch.Tensor | None = None) -> torch.Tensor:
    """y = A @ x for A in slice-transposed ELLPACK (S, W, C).

    Returns y of shape (S * C,) on x's device; callers trim to n_rows.  On
    a CUDA device one launch of kernel B6 (one thread per row); on the CPU
    the plain :func:`spmv_ell_ref`.  ``live_width`` is the slab's
    :func:`live_widths` on x's device (``ops`` caches it once per
    operand); without it the wrapper computes it itself, a pass over
    ``cols`` each call.  The walk bounds each handed-in width to ``[0,
    W]``: a width past the warp's last entry gives the true widths'
    result, a negative one walks no slot (the warp's rows read 0); the CPU
    path walks the same slots (:func:`cut_to_live`).  ``w_block`` is the
    reference's width tile: one thread walks the whole width, so it does
    not change the result.
    """
    _check_args(cols, vals, x)
    if w_block < 1:
        raise ValueError(f"w_block must be >= 1, got {w_block}")
    if live_width is not None:
        _check_live(cols, live_width)
    if not _on_card(x, "spmv_ell"):
        if live_width is not None:
            cols = cut_to_live(cols, live_width)
        return spmv_ell_ref(cols, vals, x)
    x = x.contiguous()
    live = live_widths(cols) if live_width is None else live_width
    n_slices, _, c = cols.shape
    y = torch.empty(n_slices * c, dtype=x.dtype, device=x.device)
    if y.numel():
        _launch(cols, vals, x, y, live)
    return y


def spmm_ell(cols: torch.Tensor, vals: torch.Tensor, X: torch.Tensor, *,
             live_width: torch.Tensor | None = None) -> torch.Tensor:
    """Y = A @ X for A in slice-transposed ELLPACK (S, W, C) and X
    (n_cols, k).

    Returns Y of shape (S * C, k) on X's device; callers trim to n_rows.
    On a CUDA device one launch of kernel B6's k-column form per k tile
    (:func:`repro_torch.core.autotune.ell_k_tiles`: as many columns as one
    warp's lanes hold at 16 B each, so k = 32 is one launch), every column bit-equal to :func:`spmv_ell` of that column of
    X; on the CPU the plain :func:`spmm_ell_ref`.  ``live_width`` as in
    :func:`spmv_ell` (computed here when absent; bounded the same way).
    """
    _check_rhs(cols, vals, X)
    if live_width is not None:
        _check_live(cols, live_width)
    if not _on_card(X, "spmm_ell"):
        if live_width is not None:
            cols = cut_to_live(cols, live_width)
        return spmm_ell_ref(cols, vals, X)
    X = X.contiguous()
    live = live_widths(cols) if live_width is None else live_width
    n_slices, _, c = cols.shape
    k = X.shape[1]
    Y = torch.empty((n_slices * c, k), dtype=X.dtype, device=X.device)
    if not Y.numel():
        return Y
    vec = ell_vec(k, X.element_size(), X.data_ptr() % 16 == 0)
    for k0, kt, group in ell_k_tiles(k, vec):
        _launch_tile(cols, vals, X, Y, live, k0, kt, group, vec)
    return Y
