"""Operand registry: register once, pack once, tune once, serve forever.

The port's ``repro.service.registry`` for matrix operands.  The expensive
per-operand work — signature fingerprinting, (C, sigma, k_block) tuning,
SELL packing, the launch preflight and the upload of the slabs to the
card — happens at *registration*, so request execution touches only
device-resident tensors.  The tune goes through the persistent
:class:`~repro_torch.service.tunecache.TuneCache`: registering an operand
whose signature the cache has seen (this process, an earlier one, or the
JAX reference writing the same file) performs no pad-factor measurement.

Not sharded: one registry serves one device (multi-GPU is ROADMAP A10).
"""
from __future__ import annotations

import dataclasses
from typing import Any

import torch

from repro_torch.analysis.preflight import SlabMeta, plan_spmm_sell
from repro_torch.core.autotune import SellTuneResult
from repro_torch.core.sdv import MachineParams, h100_machine
from repro_torch.kernels.execspec import resolve_device
from repro_torch.kernels.ops import pack_tuned
from repro_torch.obs import MetricsRegistry, Stopwatch
from repro_torch.service.tunecache import (
    OperandSignature,
    TuneCache,
    operand_signature,
)
from repro_torch.sparse.formats import CSRMatrix, to_csr


@dataclasses.dataclass
class RegisteredOperand:
    """One served operand: host container + tuned device-resident tensors.

    ``launches`` counts batched core calls served (one per coalesced
    group, not one per request).
    """

    name: str
    kind: str                               # matrix
    signature: OperandSignature | None
    tuned: SellTuneResult | None = None
    slabs: Any = None                       # host SellSlabs
    device_arrays: dict = dataclasses.field(default_factory=dict)
    n: int = 0                              # n_rows
    n_cols: int = 0                         # RHS length
    register_us: float = 0.0                # wall time spent registering
    tune_was_cached: bool = False
    launches: int = 0                       # batched core calls served
    slab_meta: Any = None                   # SlabMeta (bounds-scanned)
    plans: dict = dataclasses.field(default_factory=dict)  # op -> LaunchPlan

    @property
    def pad_factor(self) -> float:
        return float(self.slabs.pad_factor) if self.slabs is not None else 1.0


class KernelRegistry:
    """Named operands, packed and tuned once through a shared TuneCache,
    resident on one device (``device=None`` is the card)."""

    def __init__(self, cache: TuneCache | None = None,
                 machine: MachineParams | None = None,
                 device=None,
                 metrics: MetricsRegistry | None = None):
        self.device = resolve_device(device)
        self.cache = cache if cache is not None else TuneCache()
        # resolve the tuner's default machine eagerly: the cache key must
        # name the machine the tune actually scored against
        self.machine = machine if machine is not None else h100_machine()
        self._operands: dict[str, RegisteredOperand] = {}
        self.metrics = metrics if metrics is not None else MetricsRegistry()

    # -- lookup ------------------------------------------------------------
    def names(self) -> list[str]:
        return sorted(self._operands)

    def get(self, name: str) -> RegisteredOperand:
        try:
            return self._operands[name]
        except KeyError:
            raise KeyError(
                f"operand {name!r} not registered; have {self.names()}"
            ) from None

    def __contains__(self, name: str) -> bool:
        return name in self._operands

    def _admit(self, op: RegisteredOperand, sw: Stopwatch) -> RegisteredOperand:
        op.register_us = sw.stop().elapsed_us
        self._operands[op.name] = op
        self.metrics.histogram(
            "register_us", "wall time of operand registration "
            "(pack + tune + upload)").observe(op.register_us)
        self.metrics.counter(f"registered_{op.kind}").inc()
        if op.tune_was_cached:
            self.metrics.counter(
                "register_tune_cached",
                "registrations whose tune came from the TuneCache").inc()
        return op

    def summary(self) -> dict:
        """Registration-path observability snapshot (per-operand kind,
        registration wall time, tune-cache hit, launches, pad factor)."""
        return {
            "operands": {
                name: {
                    "kind": op.kind,
                    "register_us": round(op.register_us, 1),
                    "tune_was_cached": op.tune_was_cached,
                    "launches": op.launches,
                    "pad_factor": round(op.pad_factor, 4),
                }
                for name, op in sorted(self._operands.items())
            },
            "cache": dict(self.cache.stats),
            "repacks": dict(self.cache.repacks),
        }

    # -- registration ------------------------------------------------------
    def register_matrix(self, name: str, matrix) -> RegisteredOperand:
        """Pack + tune a sparse matrix for SpMV serving and upload it.

        Any supported format is normalized to CSR for tuning.  The tune key
        names the device the operand serves on (the card's name), so H100
        tunes never alias TPU or CPU tunes.  The registration-time
        preflight scans the stored column indices once and plans the
        launch for the tuned tiles: a corrupt pack or a stale cached tune
        is rejected here with a :class:`LaunchPlanError`, never served.
        """
        sw = Stopwatch().start()
        csr = to_csr(matrix) if not isinstance(matrix, CSRMatrix) else matrix
        sig = operand_signature(csr)
        before = self.cache.hits
        slabs, tuned = pack_tuned(
            csr, machine=self.machine, cache=self.cache,
            device=self.device,
            candidates_c=self.cache.candidate_vls_for(
                "spmv", self.machine.name),
            signature=sig,                 # skip the second content hash
        )
        op = RegisteredOperand(
            name=name, kind="matrix", signature=sig, tuned=tuned,
            slabs=slabs, n=csr.n_rows, n_cols=csr.n_cols,
            tune_was_cached=self.cache.hits > before,
        )
        op.slab_meta = SlabMeta.from_slabs(slabs, check_bounds=True)
        op.plans = {"spmv": plan_spmm_sell(
            op.slab_meta, k=max(1, tuned.k_block),
            x_dtype=str(csr.data.dtype), k_block=tuned.k_block,
        ).raise_if_invalid()}
        cols, vals, rows = slabs.to_device(self.device)
        op.device_arrays = {"cols": cols, "vals": vals, "rows": rows}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)   # upload inside register_us
        return self._admit(op, sw)
