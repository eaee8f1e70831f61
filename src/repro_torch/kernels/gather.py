"""Embedding gather on Hopper (kernel B9): the LM's token-embedding lookup.

Port of ``repro.kernels.gather``.  ``out[i] = table[ids[i]]`` for a (V, d)
table and (T,) ids, the same traffic class as the paper's SpMV x-gather.

* :func:`embedding_gather` — the wrapper.  It plans the launch first
  (:func:`repro_torch.analysis.preflight.plan_embedding_gather`): ids that
  lie on the host are range-checked there, before upload, because the
  kernel gathers unchecked and CUDA does not clamp the way JAX does.  On a
  CUDA table it launches ``csrc/embedding_gather.cu`` (one warp a row) or
  raises; on a CPU table, and only there, it runs
  :func:`embedding_gather_ref`.
* :func:`embedding_gather_ref` — the plain PyTorch version, ``table[ids]``.
"""
from __future__ import annotations

import numpy as np
import torch

from repro_torch.analysis.preflight import plan_embedding_gather
from repro_torch.core.autotune import GATHER_BLOCK_THREADS

__all__ = ["KERNEL_LAUNCHES", "embedding_gather", "embedding_gather_ref"]

#: Launches of kernel B9 by :func:`embedding_gather` in this process: one
#: per call on a CUDA table, counted where the kernel is launched and
#: nowhere else.
KERNEL_LAUNCHES = 0

_KERNEL_DTYPES = (torch.float32, torch.float64)


def embedding_gather_ref(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain ``table[ids]`` on the table's device: (T, d)."""
    return table[torch.as_tensor(ids, device=table.device).long()]


def _launch(table, ids, out) -> None:
    """One launch of kernel B9 on PyTorch's current stream of the table's
    device, made with that device current."""
    global KERNEL_LAUNCHES
    from repro_torch.kernels import cuda_lib

    lib = cuda_lib.library("embedding_gather")
    with torch.cuda.device(table.device):
        err = lib.repro_embedding_gather(
            table.data_ptr(), ids.data_ptr(), out.data_ptr(), ids.shape[0],
            table.shape[1] * table.element_size(), GATHER_BLOCK_THREADS,
            torch.cuda.current_stream().cuda_stream)
    if err != 0:
        msg = lib.repro_gather_cuda_error_string(err).decode()
        raise RuntimeError(
            f"embedding_gather kernel launch failed (cudaError {err}: {msg}) "
            f"for {ids.shape[0]} ids from a {tuple(table.shape)} table")
    KERNEL_LAUNCHES += 1


def embedding_gather(table: torch.Tensor, ids, *, vl: int = 256) -> torch.Tensor:
    """out[i] = table[ids[i]].  ``table``: (V, d) float32 or float64;
    ``ids``: (T,) integers, a numpy array or a tensor on the host or on the
    table's device (int64 tokens are converted to the kernel's int32).

    Returns (T, d) in the table's dtype on its device.  Raises
    :class:`~repro_torch.analysis.launchplan.LaunchPlanError` (a
    ``ValueError``) before any launch or upload when host ids leave
    ``[0, V)``, or ids are not integers.  ``vl`` is the reference's rows a
    grid step; the CUDA grid (one warp a row) does not depend on it.
    """
    if table.ndim != 2:
        raise ValueError(f"table must be (V, d), got shape {tuple(table.shape)}")
    if table.dtype not in _KERNEL_DTYPES:
        raise TypeError(f"table dtype {table.dtype} is not float32 or float64")
    v, d = table.shape
    plan_embedding_gather(v, d, ids, dtype=str(table.dtype).removeprefix("torch."),
                          vl=vl).raise_if_invalid()
    if isinstance(ids, np.ndarray):
        ids = torch.from_numpy(ids)
    if table.device.type == "cpu":
        return embedding_gather_ref(table, ids)
    if table.device.type != "cuda":
        raise RuntimeError(
            f"embedding_gather has a CUDA kernel and a CPU reference; got "
            f"{table.device}")
    if ids.device.type == "cuda" and ids.device != table.device:
        raise ValueError(f"ids on {ids.device}, table on {table.device}")
    ids = ids.to(device=table.device, dtype=torch.int32).contiguous()
    table = table.contiguous()
    out = torch.empty((ids.shape[0], d), dtype=table.dtype, device=table.device)
    if ids.shape[0]:
        _launch(table, ids, out)
    return out
