"""Embedding gather on Hopper (kernel B9): the LM's token-embedding lookup.

Port of ``repro.kernels.gather``.  ``out[i] = table[ids[i]]`` for a (V, d)
table and (T,) ids, the same traffic class as the paper's SpMV x-gather.

* :func:`embedding_gather` — the wrapper.  It plans the launch first
  (:func:`repro_torch.analysis.preflight.plan_embedding_gather`): ids that
  lie on the host are range-checked there on every call, before upload,
  and refused outside ``[0, V)``; the rest of the plan reads no value, so
  it is built once per shape and dtype and reused (ids already on the
  card are never read back).  On a CUDA table it launches
  ``csrc/embedding_gather.cu`` (a block per row and chunk of the row,
  int32 or int64 ids read as they are, each bounded to a row by
  :func:`clamp_ids`'s rule inside the kernel, so an id already on the card
  never reads outside the table) or raises; on a CPU table, and only
  there, it runs :func:`embedding_gather_ref`.
* :func:`embedding_gather_ref` — the plain PyTorch version,
  ``table[clamp_ids(ids, V)]``.
* :func:`clamp_ids` — the row each id reads: the reference's indexing
  rule.
"""
from __future__ import annotations

import functools
import types

import numpy as np
import torch

from repro_torch.analysis.preflight import (
    gather_ids_violation,
    ids_on_host,
    plan_embedding_gather,
)

__all__ = ["KERNEL_LAUNCHES", "clamp_ids", "embedding_gather",
           "embedding_gather_ref"]

#: Launches of kernel B9 by :func:`embedding_gather` in this process: one
#: per call on a CUDA table, counted where the kernel is launched and
#: nowhere else.
KERNEL_LAUNCHES = 0

_DTYPE_NAMES = {torch.float32: "float32", torch.float64: "float64"}
_ID_BYTES = {torch.int32: 4, torch.int64: 8}


def clamp_ids(ids: torch.Tensor, vocab: int) -> torch.Tensor:
    """The row each id reads, as int64: a negative id wraps by ``vocab``
    once, then the row is clamped to ``[0, vocab - 1]``.  This is the
    reference's rule (JAX's indexing: ids 10, 17, -1 and 2^31 - 1 of a
    10-row table all read row 9, -13 reads row 0), and the kernel applies
    the same rule on the card.  An int64 id is bounded as it is (JAX
    narrows it to int32 first, so 2^31 reads row 0 there and row
    ``vocab - 1`` here): either way no id reads outside the table."""
    ids = torch.as_tensor(ids).long()
    ids = torch.where(ids < 0, ids + vocab, ids)
    return ids.clamp(0, vocab - 1)


def embedding_gather_ref(table: torch.Tensor, ids: torch.Tensor) -> torch.Tensor:
    """Plain ``table[clamp_ids(ids, V)]`` on the table's device: (T, d)."""
    ids = torch.as_tensor(ids, device=table.device)
    return table[clamp_ids(ids, table.shape[0])]


@functools.lru_cache(maxsize=256)
def _shape_plan(vocab: int, d: int, shape: tuple, id_dtype: str, dtype: str,
                vl: int):
    """The plan of ids whose values it does not read: what it checks and
    the grid it sets depend on (V, d, T, id dtype, table dtype) alone, so
    one plan serves every call of those."""
    unread = types.SimpleNamespace(shape=shape, dtype=id_dtype, device="meta")
    return plan_embedding_gather(vocab, d, unread, dtype=dtype, vl=vl)


def _plan(vocab: int, d: int, ids, dtype: str, vl: int):
    """The launch plan of one call.  Ids on a device: the cached plan of
    their shape and dtype (their values are never read back).  Ids on the
    host: the same cached plan once their values pass the range scan, which
    runs on every call; else the full plan, naming the violation."""
    plan = _shape_plan(vocab, d, tuple(ids.shape), str(ids.dtype), dtype, vl)
    if plan.ok and ids_on_host(ids) and gather_ids_violation(ids, vocab):
        return plan_embedding_gather(vocab, d, ids, dtype=dtype, vl=vl)
    return plan


@functools.cache
def _kernel():
    """The bound C entry point and its error-string function, resolved once."""
    from repro_torch.kernels import cuda_lib

    lib = cuda_lib.library("embedding_gather")
    return lib.repro_embedding_gather, lib.repro_gather_cuda_error_string


def _launch(table, ids, out, chunks: int, threads: int) -> None:
    """One launch of kernel B9, grid (T, ``chunks``) of ``threads``, on
    PyTorch's current stream of the table's device, with that device
    current.  ``ids`` are int32 or int64 on the table's device."""
    global KERNEL_LAUNCHES
    fn, error_string = _kernel()
    index = table.device.index
    args = (table.data_ptr(), table.shape[0], ids.data_ptr(), out.data_ptr(),
            ids.shape[0],
            table.shape[1] * table.element_size(), _ID_BYTES[ids.dtype],
            chunks, threads, torch.cuda.current_stream(index).cuda_stream)
    if index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(index):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(
            f"embedding_gather kernel launch failed (cudaError {err}: "
            f"{error_string(err).decode()}) for {ids.shape[0]} ids from a "
            f"{tuple(table.shape)} table")
    KERNEL_LAUNCHES += 1


def embedding_gather(table: torch.Tensor, ids, *, vl: int = 256) -> torch.Tensor:
    """out[i] = table[ids[i]].  ``table``: (V, d) float32 or float64;
    ``ids``: (T,) integers, a numpy array or a tensor on the host or on the
    table's device.  The kernel reads int32 and int64 ids as they are
    (other integer types are widened to int64 first).

    Returns (T, d) in the table's dtype on its device.  Raises
    :class:`~repro_torch.analysis.launchplan.LaunchPlanError` (a
    ``ValueError``) before any launch or upload when host ids leave
    ``[0, V)``, or ids are not integers.  Ids already on the card are not
    read back: the kernel bounds each one by :func:`clamp_ids`'s rule.
    ``vl`` is the reference's rows a grid step; the CUDA grid does not
    depend on it.
    """
    if table.ndim != 2:
        raise ValueError(f"table must be (V, d), got shape {tuple(table.shape)}")
    dtype = _DTYPE_NAMES.get(table.dtype)
    if dtype is None:
        raise TypeError(f"table dtype {table.dtype} is not float32 or float64")
    v, d = table.shape
    plan = _plan(v, d, ids, dtype, vl)
    plan.raise_if_invalid()
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
    if ids.dtype not in _ID_BYTES:
        ids = ids.to(torch.int64)
    ids = ids.to(table.device).contiguous()
    table = table.contiguous()
    out = torch.empty((ids.shape[0], d), dtype=table.dtype, device=table.device)
    if ids.shape[0]:
        (blk,) = plan.blocks
        _launch(table, ids, out, blk.grid[1], blk.block[0])
    return out
