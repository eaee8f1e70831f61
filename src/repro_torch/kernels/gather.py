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
* :func:`embedding_gather_shard` — the vocab-shard form, for a table split
  by rows over a mesh's model axis
  (:mod:`repro_torch.models.sharding`): the shard holding rows ``[lo, lo +
  V_d)`` gathers ``table_d[r - lo]`` where the bounded row ``r =
  clamp_ids(ids, V)[i]`` (the *whole* table's V) lies in its window, else
  zeros, so the shards' outputs sum to :func:`embedding_gather` exactly.
  The same kernel, its own C entry; host ids are scanned against V before
  upload (:func:`~repro_torch.analysis.preflight
  .plan_embedding_gather_shard`).  Plain version:
  :func:`embedding_gather_shard_ref`.  It records a graph whose backward is
  :func:`embedding_gather_shard_bwd` where grad is enabled and the shard
  requires it.
* :func:`embedding_gather_bwd` — the backward, ``dtable[v] = Σ_{i: ids_i
  = v} dout_i`` (dense (V, d), XLA's scatter into zeros): one launch of
  ``csrc/embedding_gather.cu``'s backward kernel on the ids as they are
  (a block a stripe of table rows and a column chunk: it zero-fills the
  stripe while one warp reads the ids, then sums each hit row's rows of
  dout in ascending position); on CPU tensors, and only there,
  :func:`embedding_gather_bwd_ref`, the same sums in the same order.
  :func:`embedding_gather` records a graph whose backward is this only
  when grad is enabled and the table requires it.
* :func:`embedding_gather_shard_bwd` — the vocab-shard form's backward:
  the (rows, d) gradient of the rows ``[lo, lo + rows)`` a shard owns, each
  id bounded by the whole vocabulary first (as the forward bounds it), the
  ids outside the window dropped.  One launch of the backward kernel's
  shard entry (``repro_embedding_gather_shard_bwd``, the stripes over the
  shard's rows) on a CUDA ``dout``, else
  :func:`embedding_gather_shard_bwd_ref`.  A row sums its ids' rows of
  ``dout`` in ascending position from zero, as the whole-table backward,
  so the shards' gradients stacked in model order are
  :func:`embedding_gather_bwd`'s, bit for bit.

Tables are float32, float64 or bfloat16 (the reference returns a bf16
table's rows in bf16, ``gather.py:44, 52``): the forward copies bytes, a
bf16 row of odd d in 2 B vectors.  The backward sums in float32 (float64
for float64) whatever is stored and rounds a bf16 row once: from bf16
output gradients, or, for a bf16 table whose rows feed float32
activations (the model under ``param_dtype=torch.bfloat16``), from float32
ones: ``out_dtype=torch.float32`` on the forwards returns the rows widened
to float32 and records that backward, so a bf16 table's gradient is the
float32 table's rounded once, with no float32 copy of the table.
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
    plan_embedding_gather_bwd,
    plan_embedding_gather_shard,
    plan_embedding_gather_shard_bwd,
)
from repro_torch.core.autotune import (
    DTYPE_BYTES,
    GATHER_BWD_SLICE,
    gather_bwd_grid,
)

__all__ = ["BWD_LAUNCHES", "KERNEL_LAUNCHES", "SHARD_BWD_LAUNCHES",
           "SHARD_LAUNCHES", "clamp_ids", "embedding_gather",
           "embedding_gather_bwd", "embedding_gather_bwd_ref",
           "embedding_gather_ref", "embedding_gather_shard",
           "embedding_gather_shard_bwd", "embedding_gather_shard_bwd_ref",
           "embedding_gather_shard_ref"]

#: Launches of kernel B9 by :func:`embedding_gather` in this process: one
#: per call on a CUDA table, counted where the kernel is launched and
#: nowhere else.
KERNEL_LAUNCHES = 0
#: Launches of B9's vocab-shard form by :func:`embedding_gather_shard` in
#: this process: one per call on a CUDA table shard.
SHARD_LAUNCHES = 0
#: Launches of B9's backward kernel by :func:`embedding_gather_bwd` in this
#: process: one per call on a CUDA gradient.
BWD_LAUNCHES = 0
#: Launches of the shard form's backward by :func:`embedding_gather_shard_bwd`
#: in this process: one per call on a CUDA gradient.
SHARD_BWD_LAUNCHES = 0

_DTYPE_NAMES = {torch.float32: "float32", torch.float64: "float64",
                torch.bfloat16: "bfloat16"}
#: The backward entries' element-type codes (``csrc/embedding_gather.cu``).
_DTYPE_CODE = {torch.float32: 0, torch.float64: 1, torch.bfloat16: 2}
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


def _full_plan(vocab: int, d: int, ids, dtype: str, vl: int,
               shard: tuple[int, int] | None):
    """The plan of the whole-table gather, or of the shard ``(lo, rows)``
    of the table."""
    if shard is None:
        return plan_embedding_gather(vocab, d, ids, dtype=dtype, vl=vl)
    return plan_embedding_gather_shard(vocab, *shard, d, ids, dtype=dtype, vl=vl)


@functools.lru_cache(maxsize=256)
def _shape_plan(vocab: int, d: int, shape: tuple, id_dtype: str, dtype: str,
                vl: int, shard: tuple[int, int] | None = None):
    """The plan of ids whose values it does not read: what it checks and
    the grid it sets depend on (V, d, T, id dtype, table dtype, shard)
    alone, so one plan serves every call of those."""
    unread = types.SimpleNamespace(shape=shape, dtype=id_dtype, device="meta")
    return _full_plan(vocab, d, unread, dtype, vl, shard)


def _plan(vocab: int, d: int, ids, dtype: str, vl: int,
          shard: tuple[int, int] | None = None):
    """The launch plan of one call.  Ids on a device: the cached plan of
    their shape and dtype (their values are never read back).  Ids on the
    host: the same cached plan once their values pass the range scan, which
    runs on every call; else the full plan, naming the violation."""
    plan = _shape_plan(vocab, d, tuple(ids.shape), str(ids.dtype), dtype, vl,
                       shard)
    if plan.ok and ids_on_host(ids) and gather_ids_violation(ids, vocab):
        return _full_plan(vocab, d, ids, dtype, vl, shard)
    return plan


@functools.cache
def _kernel():
    """The bound C entry points and the error-string function, resolved once."""
    from repro_torch.kernels import cuda_lib

    lib = cuda_lib.library("embedding_gather")
    return (lib.repro_embedding_gather, lib.repro_embedding_gather_shard,
            lib.repro_gather_cuda_error_string)


def _launch(table, ids, out, chunks: int, threads: int,
            window: tuple[int, int] | None = None) -> None:
    """One launch of kernel B9, grid (T, ``chunks``) of ``threads``, on
    PyTorch's current stream of the table's device, with that device
    current.  ``ids`` are int32 or int64 on the table's device.
    ``window``: ``(lo, vocab)`` where ``table`` holds rows ``[lo, lo +
    len(table))`` of a vocab-row table (the vocab-shard form's entry)."""
    global KERNEL_LAUNCHES, SHARD_LAUNCHES
    whole, shard, error_string = _kernel()
    index = table.device.index
    tail = (ids.data_ptr(), out.data_ptr(), ids.shape[0],
            table.shape[1] * table.element_size(), _ID_BYTES[ids.dtype],
            chunks, threads, torch.cuda.current_stream(index).cuda_stream)
    if window is None:
        fn, args = whole, (table.data_ptr(), table.shape[0]) + tail
    else:
        fn, args = shard, (table.data_ptr(), table.shape[0]) + tuple(window) + tail
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
    if window is None:
        KERNEL_LAUNCHES += 1
    else:
        SHARD_LAUNCHES += 1


def _out_dtype(table: torch.Tensor, out_dtype) -> torch.dtype:
    """The forwards' result dtype: the table's, or float32 for a bf16
    table (its rows widened; the backward then reads float32 gradients)."""
    if out_dtype is None or out_dtype == table.dtype:
        return table.dtype
    if (table.dtype, out_dtype) != (torch.bfloat16, torch.float32):
        raise ValueError(f"out_dtype {out_dtype} for a {table.dtype} table: "
                         "the table's dtype, or float32 for a bfloat16 table")
    return out_dtype


def embedding_gather(table: torch.Tensor, ids, *, vl: int = 256,
                     out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """out[i] = table[ids[i]].  ``table``: (V, d) bfloat16, float32 or
    float64;
    ``ids``: (T,) integers, a numpy array or a tensor on the host or on the
    table's device.  The kernel reads int32 and int64 ids as they are
    (other integer types are widened to int64 first).

    Returns (T, d) in the table's dtype on its device (``out_dtype=
    torch.float32`` for a bf16 table: the rows widened, and a recorded
    backward that reads float32 gradients).  Raises
    :class:`~repro_torch.analysis.launchplan.LaunchPlanError` (a
    ``ValueError``) before any launch or upload when host ids leave
    ``[0, V)``, or ids are not integers.  Ids already on the card are not
    read back: the kernel bounds each one by :func:`clamp_ids`'s rule.
    ``vl`` is the reference's rows a grid step; the CUDA grid does not
    depend on it.
    """
    out_dtype = _out_dtype(table, out_dtype)
    table, ids, plan = _checked(table, ids, vl)
    if torch.is_grad_enabled() and table.requires_grad:
        return _EmbeddingGather.apply(table, ids, plan, out_dtype)
    return _gather(table, ids, plan).to(out_dtype)


def _checked(table: torch.Tensor, ids, vl: int,
             window: tuple[int, int] | None = None):
    """The checks of both wrappers: the table's shape and dtype, the plan
    (raised if invalid, before any upload), then the ids as a tensor (on
    the table's card as int32 / int64 for a CUDA table).  ``window``:
    ``(lo, vocab)`` of a table shard.  Returns (table, ids, plan)."""
    if table.ndim != 2:
        raise ValueError(f"table must be (V, d), got shape {tuple(table.shape)}")
    dtype = _DTYPE_NAMES.get(table.dtype)
    if dtype is None:
        raise TypeError(f"table dtype {table.dtype} is not bfloat16, float32 "
                        "or float64")
    rows, d = table.shape
    if window is None:
        plan = _plan(rows, d, ids, dtype, vl)
    else:
        plan = _plan(window[1], d, ids, dtype, vl, (window[0], rows))
    plan.raise_if_invalid()
    if isinstance(ids, np.ndarray):
        ids = torch.from_numpy(ids)
    if table.device.type == "cuda":
        if ids.device.type == "cuda" and ids.device != table.device:
            raise ValueError(f"ids on {ids.device}, table on {table.device}")
        if ids.dtype not in _ID_BYTES:
            ids = ids.to(torch.int64)
        ids = ids.to(table.device).contiguous()
    elif table.device.type != "cpu":
        raise RuntimeError(
            f"embedding_gather has a CUDA kernel and a CPU reference; got "
            f"{table.device}")
    return table, ids, plan


def _gather(table: torch.Tensor, ids: torch.Tensor, plan,
            window: tuple[int, int] | None = None) -> torch.Tensor:
    """The gather of planned ids (the shard ``window = (lo, vocab)`` of a
    table where given): the plain version on a CPU table, else one launch
    of kernel B9 (ids already on the table's card)."""
    if table.device.type == "cpu":
        if window is None:
            return embedding_gather_ref(table, ids)
        return embedding_gather_shard_ref(table, ids, *window)
    table = table.contiguous()
    out = torch.empty((ids.shape[0], table.shape[1]), dtype=table.dtype,
                      device=table.device)
    if ids.shape[0]:
        (blk,) = plan.blocks
        _launch(table, ids, out, blk.grid[1], blk.block[0], window)
    return out


def embedding_gather_shard_ref(table: torch.Tensor, ids, lo: int,
                               vocab: int) -> torch.Tensor:
    """Plain vocab-shard gather: row ``clamp_ids(ids, vocab)[i] - lo`` of
    ``table`` (rows ``[lo, lo + len(table))`` of the whole table) where the
    shard holds it, else zeros: (T, d) on the table's device."""
    ids = torch.as_tensor(ids, device=table.device)
    rows = clamp_ids(ids, vocab) - lo
    own = (rows >= 0) & (rows < table.shape[0])
    out = table[rows.clamp(0, table.shape[0] - 1)]
    return torch.where(own[:, None], out, torch.zeros((), dtype=table.dtype,
                                                       device=table.device))


def embedding_gather_shard(table: torch.Tensor, ids, lo: int, vocab: int, *,
                           vl: int = 256,
                           out_dtype: torch.dtype | None = None) -> torch.Tensor:
    """The vocab-shard form of :func:`embedding_gather`: ``table`` (V_d,
    d) holds rows ``[lo, lo + V_d)`` of a (``vocab``, d) table; returns (T,
    d), each row the gathered one where this shard holds the bounded id's
    row, else zeros.  Ids as for :func:`embedding_gather`: host ids outside
    ``[0, vocab)`` are refused before upload, ids on the card are bounded by
    ``vocab`` inside the kernel.  On a CUDA table one launch of B9 (its
    shard entry) or a raise; on a CPU table, and only there,
    :func:`embedding_gather_shard_ref`.  Where grad is enabled and
    ``table`` requires it, the graph's backward is
    :func:`embedding_gather_shard_bwd`.  ``out_dtype`` as for
    :func:`embedding_gather`."""
    window = (int(lo), int(vocab))
    out_dtype = _out_dtype(table, out_dtype)
    table, ids, plan = _checked(table, ids, vl, window)
    if torch.is_grad_enabled() and table.requires_grad:
        return _EmbeddingGatherShard.apply(table, ids, plan, window, out_dtype)
    return _gather(table, ids, plan, window).to(out_dtype)


class _EmbeddingGather(torch.autograd.Function):
    """Kernel B9 with a gradient: its backward is
    :func:`embedding_gather_bwd` on the ids the forward read, from
    gradients of ``out_dtype`` into the table's dtype."""

    @staticmethod
    def forward(ctx, table, ids, plan, out_dtype):
        ctx.vocab, ctx.dtype = table.shape[0], table.dtype
        ctx.save_for_backward(ids)
        return _gather(table, ids, plan).to(out_dtype)

    @staticmethod
    def backward(ctx, dout):
        (ids,) = ctx.saved_tensors
        return (embedding_gather_bwd(dout, ids, ctx.vocab, dtype=ctx.dtype),
                None, None, None)


class _EmbeddingGatherShard(torch.autograd.Function):
    """B9's vocab-shard form with a gradient: its backward is
    :func:`embedding_gather_shard_bwd` on the ids the forward read."""

    @staticmethod
    def forward(ctx, table, ids, plan, window, out_dtype):
        ctx.rows, ctx.dtype = table.shape[0], table.dtype
        ctx.window = window
        ctx.save_for_backward(ids)
        return _gather(table, ids, plan, window).to(out_dtype)

    @staticmethod
    def backward(ctx, dout):
        (ids,) = ctx.saved_tensors
        lo, vocab = ctx.window
        return (embedding_gather_shard_bwd(dout, ids, lo, ctx.rows, vocab,
                                           dtype=ctx.dtype),
                None, None, None, None)


def _sorted_runs(ids: torch.Tensor, vocab: int):
    """The ids bounded by :func:`clamp_ids` and stable-sorted: (sorted ids,
    their positions), equal ids forming runs in ascending position (the
    plain version's order; the kernel sorts nothing)."""
    return torch.sort(clamp_ids(ids, vocab), stable=True)


def embedding_gather_bwd_ref(dout: torch.Tensor, ids, vocab: int, *,
                             dtype: torch.dtype | None = None) -> torch.Tensor:
    """Plain backward of ``table[clamp_ids(ids)]``: the (vocab, d) table
    gradient in ``dtype`` (None: ``dout``'s), each row the sum of its ids'
    rows of ``dout`` from zero in ascending position, in promote(dout,
    float32), rounded once to ``dtype`` (the kernel's order and rounding,
    so its results are equal)."""
    dtype = dout.dtype if dtype is None else dtype
    acc_t = torch.promote_types(dout.dtype, torch.float32)
    ids = torch.as_tensor(ids, device=dout.device)
    out = torch.zeros((vocab, dout.shape[1]), dtype=dtype, device=dout.device)
    if ids.numel() == 0:
        return out
    sorted_ids, order = _sorted_runs(ids, vocab)
    rows, counts = torch.unique_consecutive(sorted_ids, return_counts=True)
    starts = torch.cumsum(counts, 0) - counts
    acc = torch.zeros((rows.shape[0], dout.shape[1]), dtype=acc_t,
                      device=dout.device)
    for k in range(int(counts.max())):
        live = counts > k
        acc[live] = acc[live] + dout[order[starts[live] + k]].to(acc_t)
    out[rows] = acc.to(dtype)
    return out


def embedding_gather_bwd(dout: torch.Tensor, ids, vocab: int, *,
                         dtype: torch.dtype | None = None) -> torch.Tensor:
    """The gradient of a (vocab, d) table gathered at ``ids`` (T,) given
    ``dout`` (T, d) bfloat16, float32 or float64; the gradient in
    ``dtype``, the table's (None: ``dout``'s; a bfloat16 table's from
    float32 ``dout`` too), summed in float32 (float64) and rounded once.
    On a CUDA ``dout``: one launch of B9's backward kernel, which reads the
    ids as they are (int32 or int64, each bounded by :func:`clamp_ids`'
    rule inside the kernel; no sort, no bound, no conversion on the card
    before it); on the CPU :func:`embedding_gather_bwd_ref`."""
    return _bwd(dout, ids, int(vocab), dtype=dtype)


def embedding_gather_shard_bwd_ref(dout: torch.Tensor, ids, lo: int, rows: int,
                                   vocab: int, *,
                                   dtype: torch.dtype | None = None
                                   ) -> torch.Tensor:
    """Plain backward of :func:`embedding_gather_shard_ref`: the (rows, d)
    gradient of rows ``[lo, lo + rows)`` of a vocab-row table, i.e. zeros
    plus ``index_add_`` of ``dout``'s rows at the ids whose bounded row
    (:func:`clamp_ids` by the whole ``vocab``) lies in the window, each row
    summed in ascending position (:func:`embedding_gather_bwd_ref` on the
    masked rows, so that the order is the same on the card too)."""
    ids = torch.as_tensor(ids, device=dout.device)
    local = clamp_ids(ids, vocab) - lo
    own = (local >= 0) & (local < rows)
    return embedding_gather_bwd_ref(dout[own], local[own], rows, dtype=dtype)


def embedding_gather_shard_bwd(dout: torch.Tensor, ids, lo: int, rows: int,
                               vocab: int, *,
                               dtype: torch.dtype | None = None) -> torch.Tensor:
    """The gradient of the shard holding rows ``[lo, lo + rows)`` of a
    (vocab, d) table gathered at ``ids`` (T,) by
    :func:`embedding_gather_shard`, given ``dout`` (T, d): (rows, d) in
    ``dtype`` (as for :func:`embedding_gather_bwd`).  On a CUDA ``dout``:
    one launch of the backward kernel's shard entry (ids read as they are,
    each bounded by ``vocab`` inside the kernel, those outside the window
    dropped), or a raise; on the CPU, and only there,
    :func:`embedding_gather_shard_bwd_ref`."""
    return _bwd(dout, ids, int(vocab), (int(lo), int(rows)), dtype=dtype)


def _bwd(dout: torch.Tensor, ids, vocab: int,
         shard: tuple[int, int] | None = None, *,
         dtype: torch.dtype | None = None) -> torch.Tensor:
    """Both backward wrappers: the checks, then the plain version on the
    CPU or one launch of the kernel (``shard``: ``(lo, rows)`` of the
    table's rows; ``dtype``: the gradient's, None for ``dout``'s)."""
    if dout.ndim != 2:
        raise ValueError(f"dout must be (T, d), got {tuple(dout.shape)}")
    if dout.dtype not in _DTYPE_NAMES:
        raise TypeError(f"dout dtype {dout.dtype} is not bfloat16, float32 "
                        "or float64")
    dtype = dout.dtype if dtype is None else dtype
    if dtype != dout.dtype and (dout.dtype, dtype) != (torch.float32,
                                                       torch.bfloat16):
        raise TypeError(f"a {dtype} gradient from {dout.dtype} dout: the "
                        "same dtype, or bfloat16 from float32")
    if not isinstance(ids, torch.Tensor):
        ids = torch.as_tensor(ids)
    if ids.shape != (dout.shape[0],):
        raise ValueError(f"ids {tuple(ids.shape)} do not match dout "
                         f"{tuple(dout.shape)}")
    dev = dout.device
    if dev.type == "cpu":
        if shard is None:
            return embedding_gather_bwd_ref(dout, ids.cpu(), vocab, dtype=dtype)
        return embedding_gather_shard_bwd_ref(dout, ids.cpu(), *shard, vocab,
                                              dtype=dtype)
    if dev.type != "cuda":
        raise RuntimeError(f"embedding_gather_bwd has a CUDA kernel and a CPU "
                           f"reference; got {dev}")
    if ids.dtype not in _ID_BYTES:
        ids = ids.to(torch.int64)
    if not ids.is_cuda:
        ids = ids.to(dev)
    elif ids.get_device() != dev.index:
        raise ValueError(f"ids on {ids.device}, dout on {dev}")
    if not ids.is_contiguous():
        ids = ids.contiguous()
    if not dout.is_contiguous():
        dout = dout.contiguous()
    d = dout.shape[1]
    plan, (stripe, chunks, threads, vec) = _bwd_plan(
        vocab, d, ids.shape[0], dout.dtype, ids.dtype, shard, dtype)
    plan.raise_if_invalid()
    if dout.data_ptr() % vec:
        dout = dout.clone()                   # a fresh allocation is aligned
    n_rows = vocab if shard is None else shard[1]
    dtable = torch.empty((n_rows, d), dtype=dtype, device=dev)
    _launch_bwd(ids, dout, dtable, vec, stripe, chunks, threads,
                None if shard is None else (shard[0], vocab))
    return dtable


@functools.lru_cache(maxsize=64)
def _bwd_plan(vocab: int, d: int, t: int, dtype: torch.dtype,
              id_dtype: torch.dtype, shard: tuple[int, int] | None = None,
              table_dtype: torch.dtype | None = None):
    """The backward's plan of one shape (``shard``: ``(lo, rows)`` of the
    shard form; ``dtype`` the output gradients', ``table_dtype`` the
    table's, None: ``dtype``) and its grid (stripe rows, chunks, threads,
    vector bytes of ``dout``), built once (a train step calls it once with
    the same shape; the checks before the launch are host time the card
    waits on)."""
    name = _DTYPE_NAMES[dtype]
    tname = name if table_dtype is None else _DTYPE_NAMES[table_dtype]
    ids = str(id_dtype).removeprefix("torch.")
    if shard is None:
        plan = plan_embedding_gather_bwd(vocab, d, t, dtype=name, id_dtype=ids,
                                         table_dtype=tname)
    else:
        plan = plan_embedding_gather_shard_bwd(vocab, *shard, d, t, dtype=name,
                                               id_dtype=ids, table_dtype=tname)
    rows = vocab if shard is None else shard[1]
    return plan, gather_bwd_grid(max(rows, 1), max(d, 1), t, DTYPE_BYTES[name])


def _launch_bwd(ids, dout, dtable, vec: int, stripe: int, chunks: int,
                threads: int, window: tuple[int, int] | None = None) -> None:
    """One launch of B9's backward kernel, grid (ceil(rows / ``stripe``),
    ``chunks``) of ``threads``, ``vec``-byte vectors of ``dout``, on
    PyTorch's current stream of the gradient's device, with that device
    current.  ``window``: ``(lo, vocab)`` where ``dtable`` is the gradient
    of rows ``[lo, lo + len(dtable))`` of a vocab-row table (the shard
    entry).  A bf16 ``dtable`` from more than one slice of ids gets its
    float32 carry (T, d) here."""
    global BWD_LAUNCHES, SHARD_BWD_LAUNCHES
    from repro_torch.kernels import cuda_lib

    lib = cuda_lib.library("embedding_gather")
    index = dout.get_device()
    t, d = dout.shape
    carry = (torch.empty((t, d), dtype=torch.float32, device=dout.device)
             if dtable.element_size() < 4 and t > GATHER_BWD_SLICE else None)
    tail = (t, d, _DTYPE_CODE[dout.dtype], _DTYPE_CODE[dtable.dtype], vec,
            stripe, chunks, threads, torch.cuda.current_stream(index).cuda_stream)
    head = (ids.data_ptr(), _ID_BYTES[ids.dtype], dout.data_ptr(),
            dtable.data_ptr(), None if carry is None else carry.data_ptr(),
            dtable.shape[0])
    if window is None:
        fn, args = lib.repro_embedding_gather_bwd, head + tail
    else:
        fn, args = lib.repro_embedding_gather_shard_bwd, head + window + tail
    if index == torch.cuda.current_device():
        err = fn(*args)
    else:
        with torch.cuda.device(index):
            err = fn(*args)
    if err != 0:
        raise RuntimeError(
            f"embedding_gather_bwd kernel launch failed (cudaError {err}: "
            f"{lib.repro_gather_cuda_error_string(err).decode()}) for "
            f"{dout.shape[0]} rows into a {tuple(dtable.shape)} table"
            + ("" if window is None else f" (rows from {window[0]} of "
                                          f"{window[1]})"))
    if window is None:
        BWD_LAUNCHES += 1
    else:
        SHARD_BWD_LAUNCHES += 1
