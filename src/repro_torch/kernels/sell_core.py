"""The batched SELL execution core on Hopper: multi-RHS SpMM + row scatter.

Port of the resident schedule of ``repro.kernels.sell_core`` (and of
``repro.kernels.sell.spmv_sell``, its k = 1 column).  k right-hand sides
against one matrix fill the RHS lanes that a single request leaves idle —
the paper's latency-tolerance argument applied across requests — so a
whole coalesced request group runs as ONE launch set: one kernel launch
per width bucket.

* :func:`spmm_sell` — the wrapper.  On CUDA tensors it launches the
  hand-written kernel ``csrc/spmm_sell.cu`` (kernel B1) once per bucket,
  or raises; there is no fallback.  On CPU tensors it runs
  :func:`spmm_sell_ref`, and only then.
* :func:`spmm_sell_ref` — the plain PyTorch version of the same function,
  for the CPU tests and for holding the kernel against on the card.

Both keep the reference's contract: every real row appears in exactly one
bucket, padding lanes scatter into a dump row (index ``n_rows``) of an
``(n_rows + 1, k_pad)`` buffer that is trimmed to ``(n_rows, k)``, and the
k axis is padded at most once (:func:`k_tile_for` / :func:`padded_k`): a
power-of-two k is never re-padded.  Never scatter with ``accumulate=True``:
pad lanes hit the dump row many times.
"""
from __future__ import annotations

import torch

from repro_torch.core.autotune import KERNEL_DTYPES, SPMM_BLOCK_THREADS
from repro_torch.sparse.formats import PAD, pow2_ceil

__all__ = [
    "KERNEL_LAUNCHES",
    "PAD",
    "k_tile_for",
    "padded_k",
    "pow2_ceil",
    "spmm_sell",
    "spmm_sell_ref",
    "spmv_sell",
]

#: Launches of kernel B1 by :func:`spmm_sell` in this process: one per
#: bucket of every call on CUDA tensors, counted where the kernel is
#: launched and nowhere else (a run shows its main path went through it).
KERNEL_LAUNCHES = 0

_KERNEL_DTYPES = tuple(getattr(torch, d) for d in KERNEL_DTYPES)


# ---------------------------------------------------------------------------
# The one RHS padding policy (copied from the reference)
# ---------------------------------------------------------------------------


def k_tile_for(k: int, k_block: int) -> int:
    """The RHS tile one thread carries: ``min(k_block, pow2_ceil(k))``.

    Both powers of two, so the tile always divides ``pow2_ceil(k)`` — the
    single-padding guarantee: a caller that pow2-pads its stack (the
    service's ``_pow2_pad``) hands the core a k it never pads again.
    """
    return min(max(int(k_block), 1), pow2_ceil(max(int(k), 1)))


def padded_k(k: int, k_block: int) -> int:
    """The k the core actually runs: ``k`` rounded up to the k tile;
    ``padded_k(pow2, k_block) == pow2`` for every pow2/k_block pair."""
    kp = k_tile_for(k, k_block)
    return kp * -(-max(int(k), 1) // kp)


# ---------------------------------------------------------------------------
# Argument contract (checked on every device, so the CPU tests reach it)
# ---------------------------------------------------------------------------


def _check_args(bucket_cols, bucket_vals, bucket_rows, x, n_rows: int) -> None:
    """Device, dtype, shape and contiguity of one launch set.  The kernel
    computes raw offsets from these shapes, so a mismatch must raise here.
    Column-index bounds are the preflight's job (a host scan at
    registration, :func:`repro_torch.analysis.preflight.plan_spmm_sell`)."""
    if not (len(bucket_cols) == len(bucket_vals) == len(bucket_rows)):
        raise ValueError("need one cols/vals/rows tensor per bucket")
    if x.ndim != 2:
        raise ValueError(f"X must be (n_cols, k), got shape {tuple(x.shape)}")
    if x.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"X dtype {x.dtype} is not float32 or float64")
    if n_rows < 0:
        raise ValueError(f"n_rows must be >= 0, got {n_rows}")
    for b, (cols, vals, rows) in enumerate(
            zip(bucket_cols, bucket_vals, bucket_rows)):
        for name, t in (("cols", cols), ("vals", vals), ("rows", rows)):
            if t.device != x.device:
                raise ValueError(
                    f"bucket {b} {name} on {t.device}, X on {x.device}")
            if not t.is_contiguous():
                raise ValueError(f"bucket {b} {name} is not contiguous")
        if cols.dtype != torch.int32 or rows.dtype != torch.int32:
            raise TypeError(f"bucket {b}: cols/rows must be int32")
        if vals.dtype != x.dtype:
            raise TypeError(
                f"bucket {b}: value dtype {vals.dtype} != X dtype {x.dtype}")
        if cols.ndim != 3 or vals.shape != cols.shape:
            raise ValueError(
                f"bucket {b}: cols {tuple(cols.shape)} / vals "
                f"{tuple(vals.shape)} are not one (S, W, C) slab")
        if tuple(rows.shape) != (cols.shape[0], cols.shape[2]):
            raise ValueError(
                f"bucket {b}: rows {tuple(rows.shape)} != (S, C) "
                f"{(cols.shape[0], cols.shape[2])}")


# ---------------------------------------------------------------------------
# Multi-RHS SpMM
# ---------------------------------------------------------------------------


def spmm_sell_ref(bucket_cols, bucket_vals, bucket_rows, x: torch.Tensor, *,
                  n_rows: int) -> torch.Tensor:
    """Y = A @ X over width-bucketed SELL slabs, in plain PyTorch.

    The kernel's arithmetic in its order: per bucket, every (slice, lane)
    row accumulates ``vals[s, w, c] * X[cols[s, w, c]]`` over w = 0 .. W-1,
    PAD entries contributing exactly zero; rows scatter into an
    ``(n_rows + 1, k)`` buffer whose dump row takes the padding lanes.
    Runs on whatever device its tensors are on.
    """
    _check_args(bucket_cols, bucket_vals, bucket_rows, x, n_rows)
    k = x.shape[1]
    y = torch.zeros((n_rows + 1, k), dtype=x.dtype, device=x.device)
    for cols, vals, rows in zip(bucket_cols, bucket_vals, bucket_rows):
        n_slices, width, c = cols.shape
        acc = torch.zeros((n_slices, c, k), dtype=x.dtype, device=x.device)
        for w in range(width):
            col = cols[:, w, :]
            mask = col != PAD
            gathered = x[torch.where(mask, col, 0).long()]    # (S, C, k)
            acc += torch.where(mask[..., None],
                               vals[:, w, :, None] * gathered, 0)
        y[rows.reshape(-1).long()] = acc.reshape(n_slices * c, k)
    return y[:n_rows]


def _launch_bucket(cols, vals, rows, x, y, k_tile: int) -> None:
    """One launch of kernel B1 on PyTorch's current stream of X's device,
    made with that device current."""
    global KERNEL_LAUNCHES
    from repro_torch.kernels import cuda_lib

    lib = cuda_lib.library("spmm_sell")
    n_slices, width, c = cols.shape
    with torch.cuda.device(x.device):
        err = lib.repro_spmm_sell_bucket(
            cols.data_ptr(), vals.data_ptr(), rows.data_ptr(), x.data_ptr(),
            y.data_ptr(), n_slices, width, c, x.shape[1], k_tile,
            SPMM_BLOCK_THREADS, int(x.dtype == torch.float64),
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.repro_cuda_error_string(err).decode()
        raise RuntimeError(
            f"spmm_sell kernel launch failed (cudaError {err}: {msg}) for a "
            f"({n_slices}, {width}, {c}) bucket, k_tile={k_tile}")
    KERNEL_LAUNCHES += 1


def spmm_sell(bucket_cols, bucket_vals, bucket_rows, x: torch.Tensor, *,
              n_rows: int, k_block: int = 8) -> torch.Tensor:
    """Y = A @ X over width-bucketed SELL slabs; X is (n_cols, k).

    Returns Y of shape (n_rows, k) on X's device.  The k axis is padded to
    the tile one thread carries (:func:`k_tile_for`) at most once.  On a
    CUDA device every bucket is one launch of kernel B1; on the CPU the
    plain :func:`spmm_sell_ref` runs instead.  Unlike the reference there
    is no ``w_block``: one thread walks a slice's whole bucket width.
    """
    _check_args(bucket_cols, bucket_vals, bucket_rows, x, n_rows)
    if x.device.type == "cpu":
        return spmm_sell_ref(bucket_cols, bucket_vals, bucket_rows, x,
                             n_rows=n_rows)
    if x.device.type != "cuda":
        raise RuntimeError(
            f"spmm_sell has a CUDA kernel and a CPU reference; got {x.device}")
    k = x.shape[1]
    kt = k_tile_for(k, k_block)
    if k % kt:
        x = torch.nn.functional.pad(x, (0, kt - k % kt))
    x = x.contiguous()
    y = torch.zeros((n_rows + 1, x.shape[1]), dtype=x.dtype, device=x.device)
    for cols, vals, rows in zip(bucket_cols, bucket_vals, bucket_rows):
        _launch_bucket(cols, vals, rows, x, y, kt)
    return y[:n_rows, :k]


def spmv_sell(bucket_cols, bucket_vals, bucket_rows, x: torch.Tensor, *,
              n_rows: int) -> torch.Tensor:
    """y = A @ x over width-bucketed SELL slabs; the k = 1 column of
    :func:`spmm_sell`.  Returns y of shape (n_rows,)."""
    return spmm_sell(bucket_cols, bucket_vals, bucket_rows, x[:, None],
                     n_rows=n_rows, k_block=1)[:, 0]
