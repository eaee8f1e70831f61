"""Public SpMV/SpMM entry points of the port (the main-path part of
``repro.kernels.ops``).

They take the host-side substrate objects (:class:`CSRMatrix`,
:class:`SellCSigmaMatrix`, :class:`SellSlabs`), normalize them to
width-bucketed SELL slabs, preflight the Hopper launch plan, upload the
slabs and X, and run :func:`repro_torch.kernels.sell_core.spmm_sell` — one
kernel launch per width bucket.  Calls run on the card unless the spec
asks for the CPU (``ExecSpec(device="cpu")``), where the plain PyTorch
reference runs instead.

Not ported yet, and refused with ``NotImplementedError`` rather than
substituted: the streaming schedule (``mode="stream"``, kernel B2), ELLPACK
operands (kernel B6) and multi-GPU placement (ROADMAP A10).  On Hopper
``mode="auto"`` always resolves to the resident kernel: X is never staged
whole in fast memory, so there is no residency limit to fall back from.
"""
from __future__ import annotations

import weakref

import numpy as np
import torch

from repro_torch.analysis.preflight import SlabMeta, plan_spmm_sell
from repro_torch.core.autotune import SellTuneResult, tune_sell_layout
from repro_torch.core.sdv import h100_machine
from repro_torch.kernels import sell_core
from repro_torch.kernels.execspec import ExecSpec, resolve_device
from repro_torch.obs import Stopwatch
from repro_torch.obs import profile as obs_profile
from repro_torch.sparse.formats import (
    CSRMatrix,
    SellCSigmaMatrix,
    SellSlabs,
    csr_to_sell_slabs,
    sell_to_slabs,
    to_csr,
)

#: ops-level execution modes for the SELL SpMM core
_SPMM_MODES = ("auto", "resident", "stream")


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


def _normalize_matrix(matrix, spec: ExecSpec) -> SellSlabs:
    """Normalize any supported matrix format to SELL slabs at the spec's
    (vl, sigma) — repack-on-mismatch memoized through the cache."""
    if type(matrix).__name__ == "EllpackMatrix":
        raise NotImplementedError(
            "ELLPACK operands run kernel B6 (spmv_ell), which is not ported "
            "yet (ROADMAP A7); pack the matrix as CSR or SELL")
    if not isinstance(matrix, (CSRMatrix, SellCSigmaMatrix, SellSlabs)):
        raise TypeError(f"unsupported sparse format: {type(matrix).__name__}")
    if not isinstance(matrix, CSRMatrix) and matrix.c != spec.vl:
        matrix = _repack_cached(matrix, spec.vl, spec.sigma, spec.cache)
    if isinstance(matrix, CSRMatrix):
        matrix = csr_to_sell_slabs(matrix, c=spec.vl, sigma=spec.sigma)
    if isinstance(matrix, SellCSigmaMatrix):
        matrix = sell_to_slabs(matrix)
    return matrix


# ---------------------------------------------------------------------------
# SpMM / SpMV
# ---------------------------------------------------------------------------


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


#: id(slabs) -> (bounds-scanned SlabMeta, {device: uploaded tensors}).
#: Packed slabs are immutable, so one operand's index scan and upload are
#: paid once however often it is called; an entry dies with its object.
_PREPARED: dict[int, tuple[SlabMeta, dict]] = {}


def _prepared(slabs: SellSlabs, device: torch.device):
    """The bounds-scanned metadata of ``slabs`` and its tensors on
    ``device``, computed at the first call on this object."""
    entry = _PREPARED.get(id(slabs))
    if entry is None:
        entry = (SlabMeta.from_slabs(slabs, check_bounds=True), {})
        _PREPARED[id(slabs)] = entry
        weakref.finalize(slabs, _PREPARED.pop, id(slabs), None)
    meta, tensors = entry
    if device not in tensors:
        tensors[device] = slabs.to_device(device)
    return meta, tensors[device]


def _spmm_slabs(slabs: SellSlabs, x: torch.Tensor, *, k_block: int,
                mode: str = "auto") -> torch.Tensor:
    """Preflight, upload and run one slab SpMM on X's device.

    Single k-padding policy (asserted here, at the ops boundary): only the
    core pads the k axis, and a power-of-two k is its fixpoint.  The plan
    checks the stored column indices: the CUDA kernel gathers ``X[col]``
    unchecked, so an out-of-range index must stop here.  The index scan and
    the upload happen once per slabs object (:func:`_prepared`).
    """
    if mode not in _SPMM_MODES:
        raise ValueError(f"unknown mode {mode!r}: expected one of {_SPMM_MODES}")
    if mode == "stream":
        raise NotImplementedError(
            "mode='stream' runs kernel B2 (the out-of-fast-memory schedule), "
            "which is not ported yet (ROADMAP A4); use mode='auto'")
    k = int(x.shape[1])
    assert sell_core.padded_k(sell_core.pow2_ceil(max(k, 1)), k_block) \
        == sell_core.pow2_ceil(max(k, 1)), "k-padding policy drifted"
    meta, (cols, vals, rows) = _prepared(slabs, x.device)
    plan = plan_spmm_sell(
        meta, k=k, x_dtype=str(x.dtype).removeprefix("torch."),
        k_block=k_block).raise_if_invalid()
    return _run_profiled("spmm", plan, lambda: sell_core.spmm_sell(
        cols, vals, rows, x, n_rows=slabs.n_rows, k_block=k_block), x.device)


def _as_rhs(x, device: torch.device) -> torch.Tensor:
    if isinstance(x, torch.Tensor):
        return x.to(device)
    return torch.from_numpy(np.ascontiguousarray(x)).to(device)


def spmm(matrix: CSRMatrix | SellCSigmaMatrix | SellSlabs, x, *,
         spec: ExecSpec | None = None) -> torch.Tensor:
    """Y = A @ X for stacked right-hand sides X of shape (n_cols, k).

    Every supported format is normalized to width-bucketed SELL slabs and
    the whole RHS stack runs as one launch set.  ``spec.k_block`` defaults
    to the power of two covering k, capped at 8 — pass the co-tuned
    :attr:`SellTuneResult.k_block` for the register-fitted value.  Returns
    Y of shape (n_rows, k) as a tensor on ``spec.device``.
    """
    spec = spec if spec is not None else ExecSpec()
    device = resolve_device(spec.device)
    x = _as_rhs(x, device)
    if x.ndim != 2:
        raise ValueError(f"spmm expects X of shape (n_cols, k), got {tuple(x.shape)}")
    kb = spec.k_block if spec.k_block is not None \
        else min(8, sell_core.pow2_ceil(x.shape[1]))
    return _spmm_slabs(_normalize_matrix(matrix, spec), x, k_block=kb,
                       mode=spec.mode)


def spmv(matrix: CSRMatrix | SellCSigmaMatrix | SellSlabs, x, *,
         spec: ExecSpec | None = None) -> torch.Tensor:
    """y = A @ x.  ``x`` may be a single (n_cols,) vector or a stacked
    (n_cols, k) RHS matrix; the latter dispatches to :func:`spmm` and
    returns (n_rows, k).

    A pre-packed matrix whose C disagrees with ``spec.vl`` is repacked
    once and the layout is memoized in the TuneCache (``spec.cache``,
    defaulting to the process-wide :func:`default_tune_cache`).
    """
    spec = spec if spec is not None else ExecSpec()
    device = resolve_device(spec.device)
    x = _as_rhs(x, device)
    if x.ndim == 2:
        return spmm(matrix, x, spec=spec)
    return _spmm_slabs(_normalize_matrix(matrix, spec), x[:, None],
                       k_block=1, mode=spec.mode)[:, 0]


# ---------------------------------------------------------------------------
# Tuned packing
# ---------------------------------------------------------------------------


def pack_tuned(
    matrix: CSRMatrix, machine=None, cache=None, device=None,
    candidates_c=None, signature=None,
) -> tuple[SellSlabs, SellTuneResult]:
    """Autotune (C, sigma, k_block) for this matrix and pack it.

    With a ``cache`` (:class:`repro_torch.service.tunecache.TuneCache`) the
    tune is a pay-once cost per operand signature, keyed by the device the
    layout runs on (:func:`device_tag`) and the machine it was tuned for
    (default :func:`repro_torch.core.sdv.h100_machine`); the packed slabs
    are memoized by (signature, C, sigma).
    ``signature`` skips re-hashing an operand the caller already
    fingerprinted.
    """
    base_key = None
    machine = machine if machine is not None else h100_machine()
    if cache is not None:
        base_key = cache.sell_key(
            "spmv", signature if signature is not None else matrix,
            device=device_tag(device), dtype=str(matrix.data.dtype),
            machine=machine)
    return tune_and_pack(
        matrix.row_lengths,
        lambda t: csr_to_sell_slabs(matrix, c=t.c, sigma=t.sigma),
        candidates_c=candidates_c, cache=cache, base_key=base_key,
    )


def cached_tune_sell(
    row_lengths, candidates_c=None, cache=None, base_key: str | None = None,
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
    )


def tune_and_pack(
    row_lengths, pack_fn, candidates_c=None, cache=None,
    base_key: str | None = None,
):
    """Cached tune + memoized pack: ``pack_fn(tuned)`` builds the layout for
    the winning (C, sigma), memoized under ``(base_key, C, sigma)``."""
    tuned = cached_tune_sell(
        row_lengths, candidates_c=candidates_c, cache=cache,
        base_key=base_key,
    )
    if cache is not None and base_key is not None:
        packed_key = (base_key, tuned.c, tuned.sigma)
        layout = cache.packed_get(packed_key)
        if layout is None:
            layout = pack_fn(tuned)
            cache.packed_put(packed_key, layout)
        return layout, tuned
    return pack_fn(tuned), tuned
