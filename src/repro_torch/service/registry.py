"""Operand registry: register once, pack once, tune once, serve forever.

The port's ``repro.service.registry`` for matrix, graph and FFT operands
and MoE dispatch envelopes.
The expensive
per-operand work — signature fingerprinting, (C, sigma, k_block) tuning,
SELL packing, the launch preflight and the upload of the slabs to the
card — happens at *registration*, so request execution touches only
device-resident tensors.  The tune goes through the persistent
:class:`~repro_torch.service.tunecache.TuneCache`: registering an operand
whose signature the cache has seen (this process, an earlier one, or the
JAX reference writing the same file) performs no pad-factor measurement.

A registry made with a ``mesh`` (an int device count, a device sequence or
a :class:`~repro_torch.kernels.sell_shard.ShardMesh`, as
``ExecSpec.placement`` takes it) packs every matrix and graph it registers
into its sharded layout as well (``mode = "sharded"``, ``sharded``, the
row-sharded plan), uploads each shard to its device, and the service runs
those operands on the sharded drives; results land on the mesh's first
device.  The matrix tune then scores the busiest shard under a key that
names the device count (``|dev{n}``), as the reference's does.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.analysis.preflight import (
    SlabMeta,
    plan_bfs_ell,
    plan_bfs_sell,
    plan_fft_stockham,
    plan_moe_dispatch,
    plan_pagerank_sell,
    plan_spmm_sell,
    plan_spmm_sell_sharded,
)
from repro_torch.core.autotune import SellTuneResult, pick_k_block
from repro_torch.core.sdv import MachineParams, h100_machine
from repro_torch.graphs.gen import (
    PAD,
    EllpackGraph,
    graph_to_sell_slabs,
    shard_graph_slabs,
)
from repro_torch.kernels import sell_shard
from repro_torch.kernels.execspec import ExecSpec, resolve_device
from repro_torch.kernels.fft import fft_twiddles
from repro_torch.kernels.ops import device_tag, pack_tuned, tune_and_pack
from repro_torch.obs import MetricsRegistry, Stopwatch
from repro_torch.service.tunecache import (
    OperandSignature,
    TuneCache,
    operand_signature,
)
from repro_torch.sparse.formats import (
    CSRMatrix,
    pow2_ceil,
    shard_slabs,
    to_csr,
)


def moe_k_block(d_model: int, dtype: str = "float64") -> int:
    """RHS tile of the MoE combine SpMM: the combine's RHS is the whole
    d_model-wide activation stack, so the tile is the widest a thread
    carries (:func:`pick_k_block` at the envelope's itemsize: 32 at fp64),
    capped at ``pow2_ceil(d_model)``.  The reference caps at 64 lanes; B1
    is instantiated up to 32, which changes tiles, not results."""
    return min(pick_k_block(np.dtype(dtype).itemsize),
               pow2_ceil(max(1, int(d_model))))


@dataclasses.dataclass
class RegisteredOperand:
    """One served operand: host container + tuned device-resident tensors.

    ``launches`` counts batched core calls served (one per coalesced
    group, not one per request).
    """

    name: str
    kind: str                               # matrix | graph | fft | moe
    signature: OperandSignature | None
    tuned: SellTuneResult | None = None
    slabs: Any = None                       # host SellSlabs | SellGraphSlabs
    device_arrays: dict = dataclasses.field(default_factory=dict)
    n: int = 0                              # n_rows / n_nodes / fft length
    n_cols: int = 0                         # RHS length
    register_us: float = 0.0                # wall time spent registering
    tune_was_cached: bool = False
    launches: int = 0                       # batched core calls served
    slab_meta: Any = None                   # SlabMeta (bounds-scanned)
    plans: dict = dataclasses.field(default_factory=dict)  # op -> LaunchPlan
    #: "sharded" when the registry carries a multi-device mesh, else
    #: "resident"
    mode: str = "resident"
    #: the device-partitioned layout (ShardedSlabs / ShardedGraphSlabs)
    #: when the registry carries a multi-device mesh, else None
    sharded: Any = None
    #: MoE dispatch envelope (kind == "moe"): slice height ``c``, ``top_k``,
    #: ``d_model`` and value ``dtype`` of the per-step routing operands
    moe: dict | None = None

    @property
    def pad_factor(self) -> float:
        return float(self.slabs.pad_factor) if self.slabs is not None else 1.0


class KernelRegistry:
    """Named operands, packed and tuned once through a shared TuneCache,
    resident on one device (``device=None`` is the card), or sharded over
    a ``mesh`` (results on its first device)."""

    def __init__(self, cache: TuneCache | None = None,
                 machine: MachineParams | None = None,
                 device=None,
                 mesh=None,
                 metrics: MetricsRegistry | None = None):
        # the placement resolves as ExecSpec's does, so the registry and
        # ops agree on what a mesh means
        placement = ExecSpec(placement=mesh)
        self.mesh = placement.resolved_placement()
        self.n_devices = placement.n_devices()
        if len(self.mesh):
            if device is not None and \
                    resolve_device(device).type != self.mesh[0].type:
                raise ValueError(f"mesh on {self.mesh[0].type} devices but "
                                 f"device={device!r}")
            device = self.mesh[0]
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
            n_devices=self.n_devices,
        )
        op = RegisteredOperand(
            name=name, kind="matrix", signature=sig, tuned=tuned,
            slabs=slabs, n=csr.n_rows, n_cols=csr.n_cols,
            tune_was_cached=self.cache.hits > before,
        )
        op.slab_meta = SlabMeta.from_slabs(slabs, check_bounds=True)
        if self.n_devices > 1:
            op.sharded = shard_slabs(slabs, self.n_devices)
            op.mode = "sharded"
            sell_shard.upload(op.sharded, self.mesh)
        op.plans = {"spmv": self.spmv_plan(op, max(1, tuned.k_block))
                    .raise_if_invalid()}
        cols, vals, rows = slabs.to_device(self.device)
        op.device_arrays = {"cols": cols, "vals": vals, "rows": rows}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)   # upload inside register_us
        return self._admit(op, sw)

    def spmv_plan(self, op: RegisteredOperand, k: int):
        """The SpMV plan of a registered matrix for a k-column group at its
        tuned tiles: B1's, or the row-sharded drive's on a mesh (each
        device's buckets against its X window)."""
        tuned = op.tuned
        if op.mode == "sharded":
            return plan_spmm_sell_sharded(
                op.slab_meta, k=k, x_dtype=op.slab_meta.val_dtype,
                n_devices=self.n_devices, k_block=tuned.k_block,
                window_cols=op.sharded.window_cols,
                shard=SlabMeta.from_sharded(op.sharded))
        return plan_spmm_sell(op.slab_meta, k=k,
                              x_dtype=op.slab_meta.val_dtype,
                              k_block=tuned.k_block)

    def register_graph(self, name: str, graph: EllpackGraph) -> RegisteredOperand:
        """Pack + tune a graph for BFS/PageRank serving and upload it.

        Both pull-style kernels consume the *reverse* adjacency, so the
        registry packs ``graph.transpose()`` into SELL slabs, tuned on the
        in-degree distribution (the row-length law of the pull traffic).
        The layout does not depend on the rank dtype, so the cache key's
        dtype is fixed to float64 (the reference's), and its device is the
        card's name.  The neighbour ids and node maps are bounds-scanned
        and the B3 launches planned before anything is uploaded.  On a
        mesh the reverse graph is node-partitioned at the tuned (C, sigma)
        as well, each shard uploaded to its device, and the plans are one
        device's.
        """
        dtype = "float64"
        sw = Stopwatch().start()
        sig = operand_signature(graph)
        key = self.cache.sell_key("graph", sig, device=device_tag(self.device),
                                  dtype=dtype, machine=self.machine)
        before = self.cache.hits
        # the forward ids first: a corrupt id must be refused by the
        # preflight, not by an index error inside the transpose
        plan_bfs_ell(SlabMeta.from_ell(graph.adj, graph.n_nodes,
                                       check_bounds=True)).raise_if_invalid()
        rgraph = graph.transpose()
        in_deg = (rgraph.adj != PAD).sum(axis=1).astype(np.int64)
        # both pull-style kernels share the layout; a pagerank (or bfs)
        # campaign hint narrows the sweep for either
        hinted = (self.cache.candidate_vls_for("pagerank", self.machine.name)
                  or self.cache.candidate_vls_for("bfs", self.machine.name))
        slabs, tuned = tune_and_pack(
            in_deg,
            lambda t: graph_to_sell_slabs(rgraph, c=t.c, sigma=t.sigma),
            candidates_c=hinted, cache=self.cache, base_key=key,
        )
        op = RegisteredOperand(
            name=name, kind="graph", signature=sig, tuned=tuned,
            slabs=slabs, n=graph.n_nodes,
            tune_was_cached=self.cache.hits > before,
        )
        op.slab_meta = SlabMeta.from_slabs(slabs, check_bounds=True)
        if self.n_devices > 1:
            op.sharded = shard_graph_slabs(rgraph, c=tuned.c,
                                           n_shards=self.n_devices,
                                           sigma=tuned.sigma)
            op.mode = "sharded"
            op.slab_meta = SlabMeta.from_sharded(op.sharded, check_bounds=True)
            sell_shard.upload(op.sharded, self.mesh)
        op.plans = {
            "bfs": plan_bfs_sell(op.slab_meta).raise_if_invalid(),
            "pagerank": plan_pagerank_sell(op.slab_meta).raise_if_invalid(),
        }
        op.device_arrays = _graph_device_arrays(slabs, graph, self.device)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)   # upload inside register_us
        return self._admit(op, sw)

    def register_fft(self, name: str, n: int) -> RegisteredOperand:
        """Precompute the twiddle plan for length-``n`` batched FFTs: the
        float64 stage tables, uploaded to the registry's device, and the
        kernel B7 launch plan of a batch of 8."""
        sw = Stopwatch().start()
        if n & (n - 1) or n < 2:
            raise ValueError(f"fft length must be a power of two >= 2, got {n}")
        wre, wim = fft_twiddles(n, np.float64)
        op = RegisteredOperand(name=name, kind="fft", signature=None, n=n)
        op.plans = {
            "fft": plan_fft_stockham(n, batch=8).raise_if_invalid()}
        op.device_arrays = {"wre": torch.from_numpy(wre).to(self.device),
                            "wim": torch.from_numpy(wim).to(self.device)}
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)   # upload inside register_us
        return self._admit(op, sw)

    def register_moe(self, name: str, *, n_tokens: int, n_slots: int,
                     d_model: int, top_k: int, c: int = 32,
                     dtype: str = "float64") -> RegisteredOperand:
        """Admit an LM engine's MoE dispatch traffic class.

        The operand itself is transient — the token->slot routing matrix
        changes every decode step — so what registers is the *envelope*: up
        to ``n_tokens`` routing rows of at most ``top_k`` stored entries
        against an ``(n_slots, d_model)`` expert-output stack, packed at
        slice height ``c``.  Its worst-case :class:`SlabMeta` is planned
        with :func:`plan_moe_dispatch` here (and again at every submit), so
        an engine whose dispatch shape cannot launch is refused before any
        token is decoded.
        """
        sw = Stopwatch().start()
        if top_k < 1:
            raise ValueError(f"top_k must be >= 1, got {top_k}")
        meta = SlabMeta(
            kind="matrix", c=int(c), widths=(pow2_ceil(int(top_k)),),
            n_slices=(-(-int(n_tokens) // int(c)),),
            n_rows=int(n_tokens), n_cols=int(n_slots),
            val_dtype=dtype, idx_dtype="int32",
        )
        op = RegisteredOperand(name=name, kind="moe", signature=None,
                               n=int(n_tokens), n_cols=int(n_slots))
        op.slab_meta = meta
        op.moe = {"c": int(c), "top_k": int(top_k),
                  "d_model": int(d_model), "dtype": dtype}
        op.plans = {"moe_dispatch": plan_moe_dispatch(
            meta, k=int(d_model), x_dtype=dtype, top_k=int(top_k),
            k_block=moe_k_block(d_model, dtype)).raise_if_invalid()}
        return self._admit(op, sw)


def _graph_device_arrays(slabs, graph: EllpackGraph, device) -> dict:
    """The reverse-graph buckets (adjacency stored (S, W, C) for coalesced
    kernel loads, see :meth:`SellGraphSlabs.to_device`), the node maps and
    the float64 out-degree vector in original node order, on ``device``."""
    adj, nodes = slabs.to_device(device)
    return {
        "adj": adj,
        "nodes": nodes,
        "out_degree": torch.from_numpy(
            graph.out_degree.astype(np.float64)).to(device),
    }
