"""Public entry points of the port (the ``repro.kernels.ops`` front door):
SpMV/SpMM, MoE dispatch, BFS, PageRank and FFT.

They take the host-side substrate objects (:class:`CSRMatrix`,
:class:`EllpackMatrix`, :class:`SellCSigmaMatrix`, :class:`SellSlabs`,
:class:`EllpackGraph`, split-plane signals), normalize and pack them,
preflight the Hopper launch plan, upload them to the card and run the
kernels:

* ``spmm`` / ``spmv`` — on the resident schedule (``spec.mode`` ``"auto"``
  or ``"resident"``) :func:`repro_torch.kernels.sell_core.spmm_sell`, one
  launch of kernel B1 per width bucket; on the streaming schedule
  (``"stream"``) :func:`repro_torch.kernels.sell_core.spmm_sell_stream`,
  one launch of kernel B2 per bucket, X staged through shared memory in
  column tiles (``spec.col_tile`` / ``spec.row_tile`` override the picked
  tiles).  An :class:`EllpackMatrix` whose slice height equals ``spec.vl``
  runs the uniform-width kernel B6 instead
  (:func:`repro_torch.kernels.spmv.spmv_ell` for one column,
  :func:`~repro_torch.kernels.spmv.spmm_ell` for k: one launch a k tile),
  one of another height is repacked to SELL slabs;
* ``moe_dispatch`` — Y = R @ X for an MoE routing matrix: packed to SELL
  slabs at ``spec.vl`` and run through the same dispatch as ``spmm``
  (``spec.dispatch`` ``"sell"`` / ``"auto"``), or materialized and
  multiplied densely (``"dense"``, the reference's counterfactual);
* ``bfs`` / ``pagerank`` — over the reverse graph, with ``spec.layout``
  ``"ell"`` (the default: ELLPACK kernels B4 / B5, two launches per level
  (B4's frontier pass and walk) or one per power step, each warp's nodes
  walked up to its live width, cached once per graph and device) or
  ``"sell"`` (kernel B3 with the BFS or PageRank combine, one launch per
  width bucket per step, k sources or configurations batched as state
  columns);
* ``fft`` — :func:`repro_torch.kernels.fft.fft_stockham`, kernel B7 (one
  launch in its in-block form, two in its two-pass form).

A ``spec.placement`` of more than one device runs ``spmm`` / ``spmv`` /
``bfs`` / ``pagerank`` on the sharded drives of
:mod:`repro_torch.kernels.sell_shard`, as the reference does: SpMM with
its RHS columns sharded when the padded k covers a whole k tile a device,
with its rows sharded otherwise; graphs node-partitioned (SELL layout
only).  The layouts are packed once per operand and memoized in the
TuneCache (``("shard", ...)`` / ``("shard-graph", ...)``); the result
lands on the mesh's first device.

``spmv``, ``spmm`` and ``moe_dispatch`` refuse an X with fewer rows than
the operand has columns before anything is uploaded, planned or launched:
the kernels gather ``X[col]`` unchecked (the reference clamps the gather
instead).  A longer X is accepted, as in the reference.

Calls run on the card unless the spec asks for the CPU
(``ExecSpec(device="cpu")``), where the plain PyTorch versions run instead.

``mode="auto"`` resolves to the resident kernel B1.  The reference streams
when X outgrows VMEM; B1 keeps nothing resident on Hopper (X is gathered
through L2), so there is no capacity limit to fall back from, and on an
H100 B2 was slower than B1 on every shape measured, banded and random, X
in L2 and far above it (``PERF.md``, ``chip_smoke.py``'s timing phase).
As in the reference these are ``ValueError``: ``mode="stream"`` with an
ELLPACK operand run by B6 or with a placement, an ELLPACK operand or a
``layout="ell"`` graph with a placement, and ``fft`` with a placement.
``moe_dispatch`` runs on one device whatever the placement, as the
reference's does.
"""
from __future__ import annotations

import functools
import weakref

import numpy as np
import torch

from repro_torch.analysis.preflight import (
    LiveWidthMeta,
    SlabMeta,
    StreamMapMeta,
    plan_bfs_ell,
    plan_bfs_sell,
    plan_fft_stockham,
    plan_moe_dispatch,
    plan_pagerank_ell,
    plan_pagerank_sell,
    plan_spmm_sell,
    plan_spmm_sell_sharded,
    plan_spmm_sell_stream,
    plan_spmv_ell,
    stream_bucket_rows,
)
from repro_torch.core.autotune import (
    SellTuneResult,
    pick_stream_tiles,
    tune_sell_layout,
)
from repro_torch.core.sdv import h100_machine
from repro_torch.graphs.gen import (
    EllpackGraph,
    graph_to_sell_slabs,
    shard_graph_slabs,
)
from repro_torch.kernels import bfs as bfs_k
from repro_torch.kernels import fft as fft_k
from repro_torch.kernels import pagerank as pr_k
from repro_torch.kernels import sell_core, sell_shard, uploads
from repro_torch.kernels import spmv as spmv_k
from repro_torch.kernels.execspec import ExecSpec, resolve_device
from repro_torch.obs import Stopwatch
from repro_torch.obs import profile as obs_profile
from repro_torch.sparse.formats import (
    CSRMatrix,
    EllpackMatrix,
    SellCSigmaMatrix,
    SellSlabs,
    csr_to_sell_slabs,
    sell_to_slabs,
    shard_slabs,
    stream_column_map,
    to_csr,
)

#: ops-level execution modes for the SELL SpMM core
_SPMM_MODES = ("auto", "resident", "stream")
#: ops-level MoE dispatch paths (ExecSpec.dispatch)
_MOE_DISPATCH_MODES = ("auto", "sell", "dense")


def device_tag(device) -> str:
    """The device string a tune is keyed on: the card's name for a GPU
    (e.g. ``"NVIDIA H100 80GB HBM3"``), ``"cpu"`` for the CPU."""
    dev = resolve_device(device)
    return torch.cuda.get_device_name(dev) if dev.type == "cuda" else "cpu"


# ---------------------------------------------------------------------------
# Repack-on-mismatch memo
# ---------------------------------------------------------------------------


_DEFAULT_CACHE = None


def default_tune_cache():
    """Process-wide in-memory TuneCache backing the repack-on-mismatch path
    (8 packed layouts, LRU); :func:`reset_default_tune_cache` releases it.
    Imported lazily: the service layer sits above kernels."""
    global _DEFAULT_CACHE
    if _DEFAULT_CACHE is None:
        from repro_torch.service.tunecache import TuneCache

        _DEFAULT_CACHE = TuneCache(max_packed=8)
    return _DEFAULT_CACHE


def reset_default_tune_cache() -> None:
    """Drop the process-wide repack memo (frees the retained slabs)."""
    global _DEFAULT_CACHE
    _DEFAULT_CACHE = None


def _repack_cached(matrix, vl: int, sigma: int | None, cache) -> SellSlabs:
    """Repack a matrix whose slice height disagrees with the requested vl,
    memoized in the TuneCache (content signature + target layout) and
    recorded once in its persisted repack ledger."""
    from repro_torch.service.tunecache import operand_signature

    cache = cache if cache is not None else default_tune_cache()
    sig = operand_signature(matrix)
    sigma = int(sigma or 8 * vl)
    key = ("repack", sig.key, vl, sigma)
    slabs = cache.packed_get(key)
    if slabs is None:
        slabs = csr_to_sell_slabs(to_csr(matrix), c=vl, sigma=sigma)
        cache.packed_put(key, slabs)
        cache.note_repack(f"repack|{sig.key}|c{vl}|sigma{sigma}")
    return slabs


def _normalize_matrix(matrix, spec: ExecSpec) -> SellSlabs | EllpackMatrix:
    """Normalize any supported matrix format toward SELL slabs at the
    spec's (vl, sigma) — repack-on-mismatch memoized through the cache.
    An :class:`EllpackMatrix` whose C equals ``spec.vl`` stays ELLPACK
    (kernel B6), as in the reference."""
    if not isinstance(matrix, (CSRMatrix, EllpackMatrix, SellCSigmaMatrix,
                               SellSlabs)):
        raise TypeError(f"unsupported sparse format: {type(matrix).__name__}")
    if not isinstance(matrix, CSRMatrix) and matrix.c != spec.vl:
        matrix = _repack_cached(matrix, spec.vl, spec.sigma, spec.cache)
    if isinstance(matrix, CSRMatrix):
        matrix = csr_to_sell_slabs(matrix, c=spec.vl, sigma=spec.sigma)
    if isinstance(matrix, SellCSigmaMatrix):
        matrix = sell_to_slabs(matrix)
    return matrix


def _placed(spec: ExecSpec):
    """``(mesh, device)`` of a call: the spec's mesh (None for one device)
    and where the result lands, the mesh's first device or
    ``spec.device``.  A mesh and a ``spec.device`` of another type are
    refused."""
    if spec.n_devices() <= 1:
        return None, resolve_device(spec.device)
    mesh = spec.resolved_placement()
    if spec.device is not None and \
            resolve_device(spec.device).type != mesh[0].type:
        raise ValueError(f"placement on {mesh[0].type} devices but "
                         f"device={spec.device!r}")
    return mesh, mesh[0]


def _signature(obj):
    """``obj``'s content signature, computed once per object (kept in its
    :mod:`uploads` entry)."""
    from repro_torch.service.tunecache import operand_signature

    entry = uploads.entry(obj)
    if "signature" not in entry:
        entry["signature"] = operand_signature(obj)
    return entry["signature"]


def _shard_cached(slabs: SellSlabs, n_shards: int, cache):
    """Row-partition slabs for a mesh, memoized like repacks: the layout
    sits in the TuneCache's packed-layout LRU under the content signature
    and the shard count (:func:`_repack_cached`'s pay-once protocol)."""
    cache = cache if cache is not None else default_tune_cache()
    sig = _signature(slabs)
    key = ("shard", sig.key, slabs.c, int(slabs.sigma or 0), int(n_shards))
    sharded = cache.packed_get(key)
    if sharded is None:
        sharded = shard_slabs(slabs, n_shards)
        cache.packed_put(key, sharded)
    return sharded


def _shard_graph_cached(rgraph: EllpackGraph, vl: int, sigma: int | None,
                        n_shards: int, cache):
    """Node-partitioned graph slabs for a mesh, memoized (see
    :func:`_shard_cached`)."""
    cache = cache if cache is not None else default_tune_cache()
    sig = _signature(rgraph)
    key = ("shard-graph", sig.key, int(vl), int(sigma or 0), int(n_shards))
    sg = cache.packed_get(key)
    if sg is None:
        sg = shard_graph_slabs(rgraph, c=vl, n_shards=n_shards, sigma=sigma)
        cache.packed_put(key, sg)
    return sg


def _sharded_graph_meta(sg) -> SlabMeta:
    """One device's bounds-scanned :class:`SlabMeta` of sharded graph slabs:
    each device runs its slices of every union bucket against the whole
    replicated state, which is what ``plan_bfs_sell`` /
    ``plan_pagerank_sell`` price."""
    return SlabMeta.from_sharded(sg, check_bounds=True)


# ---------------------------------------------------------------------------
# SpMM / SpMV
# ---------------------------------------------------------------------------


def _handed_live(live: torch.Tensor) -> torch.Tensor | None:
    """Cached live widths as handed to a B4 / B5 / B6 wrapper: none on the
    CPU, whose plain path walks every slot (the true widths cut nothing
    there), so it takes no masked copy of the slab."""
    return None if live.device.type == "cpu" else live


def _run_profiled(op: str, plan, thunk, device: torch.device):
    """Run a core call under the optional launch profiler; with one
    installed, the device is synchronized so the wall time covers the
    kernels, not their enqueue."""
    prof = obs_profile.active()
    if prof is None:
        return thunk()
    sw = Stopwatch().start()
    y = thunk()
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    sw.stop()
    prof.record(op=op, operand=plan.operand, wall_us=sw.elapsed_us, plan=plan)
    return y


#: id(operand) -> {"meta": bounds-scanned SlabMeta, device: uploaded
#: tensors, ...}, for SELL slabs and ELLPACK matrices (an ELLPACK matrix's
#: tensors also hold its live widths on that device, and the entry
#: ``"live"`` their length and range): the port's one memo of an operand's
#: scans and uploads (:mod:`uploads`), shared with the sharded drives, so
#: they are paid once however often it is called, whichever schedule runs
#: it; an entry dies with its object.
_PREPARED = uploads.ENTRIES


def _prepared(operand: SellSlabs | EllpackMatrix, device: torch.device):
    """The bounds-scanned metadata of ``operand`` and its tensors on
    ``device``, computed at the first call on this object: ``(cols, vals,
    rows)`` bucket tuples for slabs, ``(cols, vals, live)`` for an
    ELLPACK matrix, ``live`` its :func:`repro_torch.kernels.spmv
    .live_widths` computed on ``device`` (``device=None``: the metadata
    alone, nothing uploaded)."""
    entry = uploads.entry(operand)
    if "meta" not in entry:
        entry["meta"] = (SlabMeta.from_ellpack(operand, check_bounds=True)
                         if isinstance(operand, EllpackMatrix)
                         else SlabMeta.from_slabs(operand, check_bounds=True))
    if device is None:
        return entry["meta"], None
    if not isinstance(operand, EllpackMatrix):
        return entry["meta"], uploads.on_device(operand, device)
    if device not in entry:
        tensors = operand.to_device(device)
        live = spmv_k.live_widths(tensors[0])
        if "live" not in entry:
            entry["live"] = LiveWidthMeta.from_array(live)
        entry[device] = (*tensors, live)
    return entry["meta"], entry[device]


def _stream_map(slabs: SellSlabs, block_rows: tuple[int, ...],
                device: torch.device):
    """Kernel B2's block column lists of ``slabs`` for these block rows:
    their preflight metadata and their tensors on ``device``, built,
    scanned and uploaded once per (operand, block rows) and cached with the
    operand's other uploads (:func:`_prepared` makes the entry)."""
    entry = _PREPARED[id(slabs)]
    host = entry.get(("stream", block_rows))
    if host is None:
        smap = stream_column_map(slabs.bucket_cols, block_rows)
        host = entry[("stream", block_rows)] = (
            smap, StreamMapMeta.from_map(smap))
    if (device, block_rows) not in entry:
        entry[device, block_rows] = host[0].to_device(device)
    return host[1], entry[device, block_rows]


def _spmm_slabs(slabs: SellSlabs, x: torch.Tensor, *, k_block: int,
                mode: str = "auto", col_tile: int | None = None,
                row_tile: int | None = None,
                plan=plan_spmm_sell) -> torch.Tensor:
    """Preflight, upload and run one slab SpMM on X's device, on the
    resident schedule (kernel B1; ``mode`` ``"auto"`` or ``"resident"``) or
    the streaming one (kernel B2, ``"stream"``, at ``col_tile`` /
    ``row_tile`` or the tiles :func:`pick_stream_tiles` gives the k tile
    that runs).  Both schedules read the same uploaded tensors; on the
    card B2 also reads its block column lists (:func:`_stream_map`, built
    once per operand and block rows).

    ``plan`` is the resident schedule's plan, with
    :func:`plan_spmm_sell`'s signature (``moe_dispatch`` passes
    :func:`plan_moe_dispatch`, which adds the routing contract); the
    streaming plan adds its own contracts to it.  Each call plans once.

    Single k-padding policy (asserted here, at the ops boundary): only the
    core pads the k axis, and a power-of-two k is its fixpoint.  The plan
    checks the stored column indices: the CUDA kernels gather ``X[col]``
    unchecked, so an out-of-range index must stop here.  The index scan and
    the uploads happen once per slabs object (:func:`_prepared`).
    """
    _check_mode(mode)
    k = int(x.shape[1])
    assert sell_core.padded_k(sell_core.pow2_ceil(max(k, 1)), k_block) \
        == sell_core.pow2_ceil(max(k, 1)), "k-padding policy drifted"
    dtype = str(x.dtype).removeprefix("torch.")
    meta, (cols, vals, rows) = _prepared(slabs, x.device)
    if mode != "stream":
        resident = plan(meta, k=k, x_dtype=dtype,
                        k_block=k_block).raise_if_invalid()
        return _run_profiled("spmm", resident, lambda: sell_core.spmm_sell(
            cols, vals, rows, x, n_rows=slabs.n_rows, k_block=k_block),
            x.device)
    ct, rt = pick_stream_tiles(meta.c, sell_core.k_tile_for(k, k_block),
                               x.element_size())
    ct = ct if col_tile is None else col_tile
    rt = rt if row_tile is None else row_tile
    map_meta = column_map = None
    if x.device.type == "cuda" and rt >= 1:   # the plain B2 reads no map
        map_meta, column_map = _stream_map(
            slabs, stream_bucket_rows(rt, [c.shape for c in slabs.bucket_cols]),
            x.device)
    streamed = plan_spmm_sell_stream(
        meta, k=k, x_dtype=dtype, k_block=k_block, col_tile=ct,
        row_tile=rt, base=plan, column_map=map_meta).raise_if_invalid()
    return _run_profiled("spmm", streamed, lambda: sell_core.spmm_sell_stream(
        cols, vals, rows, x, n_rows=slabs.n_rows, k_block=k_block,
        col_tile=ct, row_tile=rt, column_map=column_map), x.device)


def _spmm_sharded(slabs: SellSlabs, x: torch.Tensor, spec: ExecSpec, mesh,
                  *, k_block: int) -> torch.Tensor:
    """A slab SpMM across the spec's mesh (X on its first device).  When
    the padded k covers a whole k tile a device, the RHS columns shard and
    the operand replicates (:func:`sell_shard.spmm_sell_rhs_sharded`);
    otherwise the rows shard (:func:`sell_shard.spmm_sell_sharded`, each
    device's X window, the row blocks concatenated).  Each path plans its
    per-device launches first."""
    if spec.mode == "stream":
        raise ValueError(
            "mode='stream' and a multi-device placement cannot combine: the "
            "streaming schedule is a single-device pipeline; drop the "
            "placement or use mode='auto'")
    ndev = len(mesh)
    k = int(x.shape[1])
    kp = sell_core.k_tile_for(k, k_block)
    dtype = str(x.dtype).removeprefix("torch.")
    meta, _ = _prepared(slabs, None)
    if sell_core.padded_k(k, k_block) >= ndev * kp:
        plan = plan_spmm_sell(meta, k=max(1, -(-k // ndev)), x_dtype=dtype,
                              k_block=k_block).raise_if_invalid()
        return _run_profiled("spmm", plan, lambda: sell_shard
                             .spmm_sell_rhs_sharded(slabs, x, mesh=mesh,
                                                    k_block=k_block),
                             x.device)
    sharded = _shard_cached(slabs, ndev, spec.cache)
    plan = plan_spmm_sell_sharded(
        meta, k=k, x_dtype=dtype, n_devices=ndev, k_block=k_block,
        window_cols=sharded.window_cols,
        shard=SlabMeta.from_sharded(sharded)).raise_if_invalid()
    return _run_profiled("spmm", plan, lambda: sell_shard.spmm_sell_sharded(
        sharded, x, mesh=mesh, k_block=k_block), x.device)


def _check_x_rows(x, n_cols: int, what: str) -> None:
    """Refuse an X shorter than the operand's ``n_cols``: B1, B2 and B6
    would gather ``X[col]`` past its end.  Checked on the caller's array,
    before it is uploaded; the service refuses such payloads the same
    way."""
    shape = tuple(x.shape) if hasattr(x, "shape") else np.shape(x)
    if shape and shape[0] < n_cols:
        raise ValueError(
            f"{what}: X has {shape[0]} rows, fewer than the operand's "
            f"n_cols={n_cols} (the kernels would gather past its end)")


def _as_rhs(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def _refuse_ellpack_placement(mesh) -> None:
    if mesh is not None:
        raise ValueError(
            "multi-device placement requires a SELL slab layout; ELLPACK "
            "operands only run the single-device uniform-width kernel")


def _check_mode(mode: str) -> None:
    if mode not in _SPMM_MODES:
        raise ValueError(f"unknown mode {mode!r}: expected one of {_SPMM_MODES}")


def _spmm_ellpack(ell: EllpackMatrix, x: torch.Tensor,
                  spec: ExecSpec) -> torch.Tensor:
    """Y = A @ X through kernel B6 on X's device for X (n_cols, k), trimmed
    to n_rows: at k = 1 its one-column body, else its k-column form, one
    launch a k tile.  The column bounds scan, the upload and the live
    widths happen once per matrix object (:func:`_prepared`); the plan
    refuses a stored column outside ``[PAD, n_cols)`` or a live-width array
    of the wrong length or range before the kernel reads them."""
    if spec.mode == "stream":
        raise ValueError(
            "mode='stream' requires a SELL slab layout; ELLPACK operands "
            "only run the resident uniform-width kernel")
    meta, (cols, vals, live) = _prepared(ell, x.device)
    live = _handed_live(live)
    k = int(x.shape[1])
    plan = plan_spmv_ell(
        meta, dtype=str(x.dtype).removeprefix("torch."), k=k,
        live=_PREPARED[id(ell)]["live"]).raise_if_invalid()
    if k == 1:
        w_block = max(min(spec.w_block, ell.width), 1)
        return _run_profiled("spmv", plan, lambda: spmv_k.spmv_ell(
            cols, vals, x[:, 0].contiguous(), w_block=w_block,
            live_width=live)[:ell.n_rows, None], x.device)
    return _run_profiled("spmm", plan, lambda: spmv_k.spmm_ell(
        cols, vals, x, live_width=live)[:ell.n_rows], x.device)


def spmm(matrix: CSRMatrix | EllpackMatrix | SellCSigmaMatrix | SellSlabs,
         x, *, spec: ExecSpec | None = None) -> torch.Tensor:
    """Y = A @ X for stacked right-hand sides X of shape (n_cols, k).

    Every supported format is normalized to width-bucketed SELL slabs and
    the whole RHS stack runs as one launch set.  ``spec.k_block`` defaults
    to the power of two covering k, capped at 8 — pass the co-tuned
    :attr:`SellTuneResult.k_block` for the register-fitted value.  An
    :class:`EllpackMatrix` at ``C == spec.vl`` runs kernel B6 (the paper's
    baseline): its k-column form, one launch a k tile (k = 32 is one
    launch), each column bit-equal to a one-column B6 walk.  Returns Y of
    shape (n_rows, k) as a tensor on ``spec.device``.  A multi-device
    ``spec.placement`` runs the sharded drives (RHS-sharded when k covers a
    k tile a device, row-sharded otherwise), the result on the mesh's
    first device.
    """
    spec = spec if spec is not None else ExecSpec()
    mesh, device = _placed(spec)
    _check_x_rows(x, getattr(matrix, "n_cols", 0), "spmm")
    x = _as_rhs(x, device)
    if x.ndim != 2:
        raise ValueError(f"spmm expects X of shape (n_cols, k), got {tuple(x.shape)}")
    _check_mode(spec.mode)
    kb = spec.k_block if spec.k_block is not None \
        else min(8, sell_core.pow2_ceil(x.shape[1]))
    matrix = _normalize_matrix(matrix, spec)
    if isinstance(matrix, SellSlabs):
        if mesh is not None:
            return _spmm_sharded(matrix, x, spec, mesh, k_block=kb)
        return _spmm_slabs(matrix, x, k_block=kb, mode=spec.mode,
                           col_tile=spec.col_tile, row_tile=spec.row_tile)
    _refuse_ellpack_placement(mesh)
    return _spmm_ellpack(matrix, x, spec)


def spmv(matrix: CSRMatrix | EllpackMatrix | SellCSigmaMatrix | SellSlabs,
         x, *, spec: ExecSpec | None = None) -> torch.Tensor:
    """y = A @ x.  ``x`` may be a single (n_cols,) vector or a stacked
    (n_cols, k) RHS matrix; the latter dispatches to :func:`spmm` and
    returns (n_rows, k).

    CSR, SELL and slabs run the bucketed kernel B1; an
    :class:`EllpackMatrix` at ``C == spec.vl`` runs the uniform-width
    kernel B6.  A pre-packed matrix whose C disagrees with ``spec.vl`` is
    repacked once to SELL slabs and the layout is memoized in the
    TuneCache (``spec.cache``, defaulting to the process-wide
    :func:`default_tune_cache`).  A multi-device ``spec.placement`` runs
    the row-sharded drive.
    """
    spec = spec if spec is not None else ExecSpec()
    mesh, device = _placed(spec)
    _check_x_rows(x, getattr(matrix, "n_cols", 0), "spmv")
    x = _as_rhs(x, device)
    if x.ndim == 2:
        return spmm(matrix, x, spec=spec)
    _check_mode(spec.mode)
    matrix = _normalize_matrix(matrix, spec)
    if isinstance(matrix, SellSlabs):
        if mesh is not None:
            return _spmm_sharded(matrix, x[:, None], spec, mesh,
                                 k_block=1)[:, 0]
        return _spmm_slabs(matrix, x[:, None], k_block=1, mode=spec.mode,
                           col_tile=spec.col_tile,
                           row_tile=spec.row_tile)[:, 0]
    _refuse_ellpack_placement(mesh)
    return _spmm_ellpack(matrix, x[:, None], spec)[:, 0]


# ---------------------------------------------------------------------------
# MoE dispatch
# ---------------------------------------------------------------------------


def _routing_dense(routing: CSRMatrix) -> np.ndarray:
    """Materialize the routing matrix densely — the counterfactual the
    ``dispatch="dense"`` path executes (one matrix product over the same
    operand, exactly what the masked one-hot einsum reduces to)."""
    dense = np.zeros((routing.n_rows, routing.n_cols), routing.data.dtype)
    rows = np.repeat(np.arange(routing.n_rows), np.diff(routing.indptr))
    dense[rows, routing.indices] = routing.data
    return dense


def moe_dispatch(routing: CSRMatrix | SellSlabs, x, *,
                 spec: ExecSpec | None = None, top_k: int) -> torch.Tensor:
    """Y = R @ X for the MoE token<->slot routing matrix R.

    ``routing`` is one step's combine matrix (one row per token, at most
    ``top_k`` stored entries — the renormalized router weights — whose
    columns are expert capacity slots) and ``x`` the ``(n_slots,
    d_model)`` expert-output stack.  Returns the ``(n_tokens, d_model)``
    combined activations on ``spec.device``.

    ``spec.dispatch`` selects the path: ``"sell"`` / ``"auto"`` pack R into
    width-bucketed SELL slabs at ``spec.vl`` and run the SpMM dispatch of
    :func:`spmm` (kernel B1; B2 under ``mode="stream"``), the whole
    activation stack in one launch set; ``"dense"`` materializes R and runs
    one ``torch.matmul``, the counterfactual the reference measures the
    SELL path against.  ``spec.k_block`` defaults to ``min(8,
    pow2_ceil(d_model))``.  Every SELL launch is first preflighted with
    :func:`plan_moe_dispatch` (the SpMM contracts plus the routing shape:
    no bucket wider than ``pow2_ceil(top_k)``).
    """
    spec = spec if spec is not None else ExecSpec()
    if spec.dispatch not in _MOE_DISPATCH_MODES:
        raise ValueError(
            f"unknown dispatch {spec.dispatch!r}: expected one of "
            f"{_MOE_DISPATCH_MODES}")
    device = resolve_device(spec.device)
    _check_x_rows(x, getattr(routing, "n_cols", 0), "moe_dispatch")
    x = _as_rhs(x, device)
    if x.ndim != 2:
        raise ValueError(
            f"moe_dispatch expects X of shape (n_slots, d), got "
            f"{tuple(x.shape)}")
    if spec.dispatch == "dense":
        if not isinstance(routing, CSRMatrix):
            raise TypeError(
                "dispatch='dense' materializes the routing matrix and needs "
                f"CSR input, got {type(routing).__name__}")
        return torch.matmul(
            torch.from_numpy(_routing_dense(routing)).to(device), x)
    if isinstance(routing, CSRMatrix):
        routing = csr_to_sell_slabs(routing, c=spec.vl, sigma=spec.sigma)
    if not isinstance(routing, SellSlabs):
        raise TypeError(
            f"routing must be a CSRMatrix or SellSlabs, got "
            f"{type(routing).__name__}")
    kb = spec.k_block if spec.k_block is not None \
        else min(8, sell_core.pow2_ceil(x.shape[1]))
    return _spmm_slabs(routing, x, k_block=kb, mode=spec.mode,
                       col_tile=spec.col_tile, row_tile=spec.row_tile,
                       plan=functools.partial(plan_moe_dispatch, top_k=top_k))


# ---------------------------------------------------------------------------
# BFS / PageRank
# ---------------------------------------------------------------------------

#: id(graph) -> {"ids": forward SlabMeta (bounds-scanned), "reverse": the
#: transposed graph, (layout, vl, sigma, device): (meta, tensors, degree),
#: and once the ELLPACK layout is uploaded "live": the length and range of
#: its live widths}.  Graphs are treated as immutable, so one graph's id
#: scan, transpose, packing, upload and live widths are paid once however
#: often it is served; an entry dies with its object.
_PREPARED_GRAPHS: dict[int, dict] = {}


def _graph_entry(graph: EllpackGraph, plan_ids) -> dict:
    """``graph``'s entry of :data:`_PREPARED_GRAPHS`, its forward ids
    planned (``plan_ids``, the ELLPACK plan of the calling op: a corrupt id
    is refused with a :class:`LaunchPlanError` before the transpose indexes
    with it) and its reverse graph made once."""
    if not isinstance(graph, EllpackGraph):
        raise TypeError(f"expected an EllpackGraph, got {type(graph).__name__}")
    entry = _PREPARED_GRAPHS.get(id(graph))
    if entry is None:
        entry = {"ids": SlabMeta.from_ell(graph.adj, graph.n_nodes,
                                          check_bounds=True)}
        _PREPARED_GRAPHS[id(graph)] = entry
        weakref.finalize(graph, _PREPARED_GRAPHS.pop, id(graph), None)
    plan_ids(entry["ids"]).raise_if_invalid()
    if "reverse" not in entry:
        entry["reverse"] = graph.transpose()
    return entry


def _sharded_graph(graph: EllpackGraph, spec: ExecSpec, mesh, plan_ids):
    """The node-partitioned reverse graph of ``graph`` for ``mesh`` and its
    one-device :class:`SlabMeta` (SELL layout only, as in the reference)."""
    if spec.layout != "sell":
        raise ValueError(
            "multi-device placement requires layout='sell' (the ELLPACK "
            "drive has no sharded path)")
    sg = _shard_graph_cached(_graph_entry(graph, plan_ids)["reverse"],
                             spec.vl, spec.sigma, len(mesh), spec.cache)
    return sg, _sharded_graph_meta(sg)


def _prepared_graph(graph: EllpackGraph, spec: ExecSpec, device, plan_ids):
    """The reverse graph of ``graph`` in ``spec.layout``, bounds-scanned and
    uploaded to ``device``: ``(meta, tensors, out_degree)``, ``tensors``
    ``(adj, nodes)`` bucket tuples for SELL and ``(radj, live)`` for
    ELLPACK, ``live`` its :func:`repro_torch.kernels.bfs.ell_live_widths`
    computed on ``device``.

    The forward neighbour ids are planned first (:func:`_graph_entry`).
    """
    entry = _graph_entry(graph, plan_ids)
    rgraph = entry["reverse"]
    key = (spec.layout, spec.vl, spec.sigma, device)
    if key not in entry:
        if spec.layout == "sell":
            slabs = graph_to_sell_slabs(rgraph, c=spec.vl, sigma=spec.sigma)
            meta = SlabMeta.from_slabs(slabs, check_bounds=True)
            tensors = slabs.to_device(device)
        else:
            meta = SlabMeta.from_ell(rgraph.adj, graph.n_nodes,
                                     check_bounds=True)
            radj = rgraph.to_device(device)
            live = bfs_k.ell_live_widths(radj)
            if "live" not in entry:
                entry["live"] = LiveWidthMeta.from_array(live)
            tensors = (radj, live)
        deg = torch.from_numpy(graph.out_degree.astype(np.float64)).to(device)
        entry[key] = (meta, tensors, deg)
    return entry[key]


def _graph_spec(spec: ExecSpec | None) -> tuple[ExecSpec, torch.device]:
    spec = spec if spec is not None else ExecSpec()
    if spec.layout not in ("ell", "sell"):
        raise ValueError(
            f"unknown layout {spec.layout!r}: expected 'ell' or 'sell'")
    return spec, _placed(spec)[1]


def bfs(graph: EllpackGraph, source=0, *,
        spec: ExecSpec | None = None) -> torch.Tensor:
    """BFS distances from ``source`` (INF = unreachable), int32.

    Bottom-up expansion needs *in*-neighbours, so the kernels run over the
    reverse graph.  ``spec.layout = "sell"`` runs kernel B3 over
    in-degree-sorted, width-bucketed slabs (skewed graphs stop paying the
    global max in-degree per node); the default ``"ell"`` runs kernel B4
    over the degree-padded ELLPACK reverse adjacency.

    ``source`` may be one node id or a sequence of k ids.  A sequence
    returns stacked (n_nodes, k) distances, one column per source; on the
    SELL layout the whole stack advances through one launch set per level,
    on ELLPACK the sources run one by one.  Returns a tensor on
    ``spec.device``.

    A multi-device ``spec.placement`` (SELL layout only) node-partitions
    the reverse graph and, every level, unions the shards' frontiers by an
    element-wise minimum on the mesh's first device, where the result
    lands (:func:`sell_shard.bfs_sell_sharded`).
    """
    spec, device = _graph_spec(spec)
    if mesh := _placed(spec)[0]:
        sg, meta = _sharded_graph(graph, spec, mesh, plan_bfs_ell)
        plan = plan_bfs_sell(meta, k=int(np.size(source))).raise_if_invalid()
        return _run_profiled("bfs", plan, lambda: sell_shard.bfs_sell_sharded(
            sg, source, mesh=mesh), mesh[0])
    meta, tensors, _ = _prepared_graph(graph, spec, device, plan_bfs_ell)
    n = graph.n_nodes
    if spec.layout == "sell":
        plan = plan_bfs_sell(meta, k=int(np.size(source))).raise_if_invalid()
        adj, nodes = tensors
        return _run_profiled("bfs", plan, lambda: bfs_k.bfs_sell(
            adj, nodes, n, source), device)
    plan = plan_bfs_ell(
        meta, live=_PREPARED_GRAPHS[id(graph)]["live"]).raise_if_invalid()
    radj, live = tensors
    live = _handed_live(live)
    if np.ndim(source) == 0:
        return _run_profiled("bfs", plan, lambda: bfs_k.bfs(
            radj, int(source), vl=spec.vl, live_width=live), device)
    return torch.stack([bfs_k.bfs(radj, int(s), vl=spec.vl, live_width=live)
                        for s in np.asarray(source)], dim=1)


def pagerank(graph: EllpackGraph, *, damping=0.85, iters=20,
             spec: ExecSpec | None = None,
             dtype: torch.dtype = pr_k.RANK_DTYPE) -> torch.Tensor:
    """PageRank scores via the pull-style kernels on the reverse graph, in
    ``dtype``: float64 (the reference's x64 path) or float32 (its x64-off
    path; B3 and B5 have a form for each).

    ``spec.layout = "sell"`` runs kernel B3 over in-degree-sorted,
    width-bucketed reverse adjacency; the default ``"ell"`` runs kernel B5.
    ``damping`` / ``iters`` may be scalars or sequences (broadcast against
    each other): sequences return stacked (n_nodes, k) ranks, one column
    per configuration; on the SELL layout every power step is one launch
    set for all k columns, on ELLPACK the configurations run one by one.
    Returns a tensor on ``spec.device``.

    A multi-device ``spec.placement`` (SELL layout only) node-partitions
    the reverse graph; every power step each shard writes its own nodes'
    new ranks and the shards' ranks are summed on the mesh's first device,
    where the result lands (:func:`sell_shard.pagerank_sell_sharded`).
    """
    spec, device = _graph_spec(spec)
    k = max(int(np.size(damping)), int(np.size(iters)))
    rank_dtype = str(dtype).removeprefix("torch.")
    if mesh := _placed(spec)[0]:
        sg, meta = _sharded_graph(graph, spec, mesh, plan_pagerank_ell)
        plan = plan_pagerank_sell(meta, k=k,
                                  dtype=rank_dtype).raise_if_invalid()
        deg = torch.from_numpy(graph.out_degree.astype(np.float64))
        return _run_profiled(
            "pagerank", plan, lambda: sell_shard.pagerank_sell_sharded(
                sg, deg, mesh=mesh, damping=damping, iters=iters,
                dtype=dtype), mesh[0])
    meta, tensors, deg = _prepared_graph(graph, spec, device,
                                         plan_pagerank_ell)
    n = graph.n_nodes
    if spec.layout == "sell":
        plan = plan_pagerank_sell(meta, k=k,
                                  dtype=rank_dtype).raise_if_invalid()
        radj, nodes = tensors
        return _run_profiled("pagerank", plan, lambda: pr_k.pagerank_sell(
            radj, nodes, deg, n, damping=damping, iters=iters, dtype=dtype),
            device)
    plan = plan_pagerank_ell(
        meta, dtype=rank_dtype,
        live=_PREPARED_GRAPHS[id(graph)]["live"]).raise_if_invalid()
    radj, live = tensors
    live = _handed_live(live)
    if np.ndim(damping) == 0 and np.ndim(iters) == 0:
        return _run_profiled("pagerank", plan, lambda: pr_k.pagerank(
            radj, deg, damping=float(damping), iters=int(iters),
            vl=spec.vl, live_width=live, dtype=dtype), device)
    dampings, iters_arr = pr_k.broadcast_configs(damping, iters)
    return torch.stack([
        pr_k.pagerank(radj, deg, damping=float(d), iters=int(it),
                      vl=spec.vl, live_width=live, dtype=dtype)
        for d, it in zip(dampings, iters_arr)], dim=1)


# ---------------------------------------------------------------------------
# FFT
# ---------------------------------------------------------------------------


@functools.lru_cache(maxsize=8)
def _twiddles_on(n: int, dtype: torch.dtype, device: torch.device):
    """The stage tables of length-``n`` FFTs in ``dtype`` on ``device``,
    built (in float64, then cast) and uploaded once per process."""
    wre, wim = fft_k.fft_twiddles(n, np.float64)
    return tuple(torch.from_numpy(w).to(device=device, dtype=dtype)
                 for w in (wre, wim))


def _as_signal(a, device: torch.device) -> torch.Tensor:
    return torch.atleast_2d(_as_rhs(a, device))


def fft(signal_re, signal_im=None, *,
        spec: ExecSpec | None = None) -> tuple[torch.Tensor, torch.Tensor]:
    """Batched FFT of (batch, n) split-plane signals (n a power of two).

    A 1-D signal is one row; ``signal_im=None`` is a zero imaginary plane.
    ``spec.b_block`` caps the signals one block of kernel B7 holds (capped
    again to the shared memory a block may claim; the result does not
    depend on it).  Returns ``(re, im)`` tensors of shape (batch, n) on
    ``spec.device``.  There is no sharded FFT: a multi-device placement is
    refused, as in the reference.
    """
    spec = spec if spec is not None else ExecSpec()
    if spec.n_devices() > 1:
        raise ValueError(
            "fft has no sharded execution path; use a single-device "
            "placement")
    device = resolve_device(spec.device)
    re = _as_signal(signal_re, device)
    im = torch.zeros_like(re) if signal_im is None \
        else _as_signal(signal_im, device)
    n = re.shape[-1]
    if n & (n - 1):
        raise ValueError(f"n must be a power of two, got {n}")
    bb = min(spec.b_block, re.shape[0])
    plan = plan_fft_stockham(
        int(n), batch=int(re.shape[0]), b_block=int(bb),
        dtype=str(re.dtype).removeprefix("torch."),
    ).raise_if_invalid()
    wre, wim = _twiddles_on(int(n), re.dtype, device)
    return _run_profiled("fft", plan, lambda: fft_k.fft_stockham(
        re, im, wre, wim, b_block=bb), device)


# ---------------------------------------------------------------------------
# Tuned packing
# ---------------------------------------------------------------------------


def pack_tuned(
    matrix: CSRMatrix, machine=None, cache=None, device=None,
    candidates_c=None, signature=None, n_devices: int = 1,
) -> tuple[SellSlabs, SellTuneResult]:
    """Autotune (C, sigma, k_block) for this matrix and pack it.

    With a ``cache`` (:class:`repro_torch.service.tunecache.TuneCache`) the
    tune is a pay-once cost per operand signature, keyed by the device the
    layout runs on (:func:`device_tag`) and the machine it was tuned for
    (default :func:`repro_torch.core.sdv.h100_machine`); the packed slabs
    are memoized by (signature, C, sigma).
    ``signature`` skips re-hashing an operand the caller already
    fingerprinted.  ``n_devices > 1`` tunes for the row-sharded drive (the
    busiest shard's rows, keyed ``|dev{n}``).
    """
    base_key = None
    machine = machine if machine is not None else h100_machine()
    if cache is not None:
        base_key = cache.sell_key(
            "spmv", signature if signature is not None else matrix,
            device=device_tag(device), dtype=str(matrix.data.dtype),
            machine=machine, n_devices=n_devices)
    return tune_and_pack(
        matrix.row_lengths,
        lambda t: csr_to_sell_slabs(matrix, c=t.c, sigma=t.sigma),
        candidates_c=candidates_c, cache=cache, base_key=base_key,
        n_devices=n_devices,
    )


def cached_tune_sell(
    row_lengths, candidates_c=None, cache=None, base_key: str | None = None,
    n_devices: int = 1,
) -> SellTuneResult:
    """The one cached-tune protocol: a narrowed candidate sweep lives under
    a ``|cands...``-suffixed key and never masquerades as a full-sweep
    tune; on a hinted miss the full-grid entry is consulted first."""
    key = base_key
    if candidates_c is not None and base_key is not None:
        key = base_key + "|cands" + "-".join(map(str, sorted(candidates_c)))
        if cache is not None:
            full = cache.get_sell(base_key)
            if full is not None:
                return full
    return tune_sell_layout(
        row_lengths, candidates_c=candidates_c, cache=cache, cache_key=key,
        n_devices=n_devices,
    )


def tune_and_pack(
    row_lengths, pack_fn, candidates_c=None, cache=None,
    base_key: str | None = None, n_devices: int = 1,
):
    """Cached tune + memoized pack: ``pack_fn(tuned)`` builds the layout for
    the winning (C, sigma), memoized under ``(base_key, C, sigma)``."""
    tuned = cached_tune_sell(
        row_lengths, candidates_c=candidates_c, cache=cache,
        base_key=base_key, n_devices=n_devices,
    )
    if cache is not None and base_key is not None:
        packed_key = (base_key, tuned.c, tuned.sigma)
        layout = cache.packed_get(packed_key)
        if layout is None:
            layout = pack_fn(tuned)
            cache.packed_put(packed_key, layout)
        return layout, tuned
    return pack_fn(tuned), tuned
