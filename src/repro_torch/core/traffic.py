"""Transaction traces for the paper's four kernels (§3.1).

A copy of ``repro.core.traffic``.  Each builder mirrors the blocked
schedule of the reference's kernel (same slice decomposition, same inner
loop structure, same data structures) and emits the per-iteration memory
instruction mix that :class:`repro_torch.core.sdv.SDVMachine` turns into
cycles.  The problems (:data:`PAPER_PROBLEMS`) are the paper's inputs:
CAGE10, a 2^15-node graph of degree 16 and one 2048-point FFT; the port's
measured counterparts (:func:`repro_torch.core.campaign.measure_cuda`) time
its kernels on the same ones.

Scalar baselines are the same algorithms traced at ``vl = 1`` with the scalar
core's in-order characteristics (one outstanding miss, per-element loop
overhead) — the paper's scalar binaries, modeled through the same machine.
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.sdv import MemOp, Phase, Trace
from repro_torch.core.vconfig import VectorConfig

F64 = 8
F32 = 4
I32 = 4

# ---------------------------------------------------------------------------
# Problem descriptors (the paper's inputs)
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class SpMVProblem:
    """Sparse matrix in SELL-C-sigma/ELLPACK layout (C = vl)."""

    n_rows: int = 11_397          # CAGE10
    n_cols: int = 11_397
    nnz: int = 150_645
    pad_factor: float = 1.08      # ELL padding overhead after sigma-sort

    @property
    def avg_nnz_row(self) -> float:
        return self.nnz / self.n_rows

    @property
    def ell_width(self) -> int:
        return int(math.ceil(self.avg_nnz_row * self.pad_factor))


@dataclasses.dataclass(frozen=True)
class GraphProblem:
    """Graph in ELLPACK adjacency (degree-padded), 2^15 nodes as in §3.1."""

    n_nodes: int = 1 << 15
    avg_degree: int = 16
    pad_factor: float = 1.3
    bfs_levels: int = 6           # typical eccentricity of the test graph
    pr_iters: int = 10

    @property
    def n_edges(self) -> int:
        return self.n_nodes * self.avg_degree

    @property
    def ell_width(self) -> int:
        return int(math.ceil(self.avg_degree * self.pad_factor))


@dataclasses.dataclass(frozen=True)
class FFTProblem:
    n: int = 2048                 # paper's FFT size
    batch: int = 1

    @property
    def stages(self) -> int:
        return int(math.log2(self.n))


PAPER_PROBLEMS = {
    "spmv": SpMVProblem(),
    "bfs": GraphProblem(),
    "pagerank": GraphProblem(),
    "fft": FFTProblem(),
}

# ---------------------------------------------------------------------------
# SpMV — SELL-C-sigma gather-MAC (kernels/spmv.py)
# ---------------------------------------------------------------------------


def spmv_trace(prob: SpMVProblem, vcfg: VectorConfig) -> Trace:
    vl = vcfg.vl
    if vcfg.is_scalar:
        # CSR scalar loop: per nnz load col idx, load value, gather x[col],
        # fused MAC; ~4 cycles of in-order loop/address overhead.
        phase = Phase(
            name="csr-scalar",
            n_iters=prob.nnz,
            mem_ops=(
                (MemOp("colidx", "unit", 1, I32, prob.nnz * I32, reused=False), 1.0),
                (MemOp("values", "unit", 1, F64, prob.nnz * F64, reused=False), 1.0),
                (MemOp("x-gather", "gather", 1, F64, prob.n_cols * F64, reused=True), 1.0),
            ),
            valu_ops=0.0,
            scalar_cycles=5.0,
            serial_mem_groups=2.0,    # colidx -> x[colidx] dependency
        )
        return Trace("spmv", vcfg, (phase,), (("nnz", prob.nnz),))

    n_slices = math.ceil(prob.n_rows / vl)
    width = prob.ell_width
    # Per slice x inner column step: load vl values + vl col indices
    # (unit-stride in SELL layout), gather vl entries of x, masked FMA.
    inner = Phase(
        name="sell-gather-mac",
        n_iters=n_slices * width,
        mem_ops=(
            (MemOp("values", "unit", vl, F64, prob.nnz * F64, reused=False), 1.0),
            (MemOp("colidx", "unit", vl, I32, prob.nnz * I32, reused=False), 1.0),
            (MemOp("x-gather", "gather", vl, F64, prob.n_cols * F64, reused=True), 1.0),
        ),
        valu_ops=3.0,                 # mask compare, select, fma
        scalar_cycles=4.0,
        serial_mem_groups=2.0,
    )
    store = Phase(
        name="y-store",
        n_iters=n_slices,
        mem_ops=((MemOp("y", "unit", vl, F64, prob.n_rows * F64, reused=False), 1.0),),
        valu_ops=1.0,
        scalar_cycles=6.0,
    )
    return Trace("spmv", vcfg, (inner, store), (("nnz", prob.nnz),))


# ---------------------------------------------------------------------------
# BFS — frontier expansion over ELLPACK adjacency (kernels/bfs.py)
# ---------------------------------------------------------------------------


def bfs_trace(prob: GraphProblem, vcfg: VectorConfig) -> Trace:
    vl = vcfg.vl
    n, w = prob.n_nodes, prob.ell_width
    dist_fp = n * I32
    adj_fp = n * w * I32
    if vcfg.is_scalar:
        # Top-down scalar BFS: each edge of the graph relaxed once across the
        # whole run; per edge: load neighbor id, load its dist, maybe store.
        expand = Phase(
            name="edge-relax-scalar",
            n_iters=prob.n_edges,
            mem_ops=(
                (MemOp("adj", "unit", 1, I32, adj_fp, reused=False), 1.0),
                (MemOp("dist", "gather", 1, I32, dist_fp, reused=True), 1.0),
                (MemOp("dist-upd", "scatter", 1, I32, dist_fp, reused=True), 0.2),
            ),
            scalar_cycles=6.0,
            serial_mem_groups=2.0,
        )
        frontier = Phase(
            name="frontier-scan-scalar",
            n_iters=prob.bfs_levels * n,
            mem_ops=((MemOp("dist-scan", "unit", 1, I32, dist_fp, reused=True), 1.0),),
            scalar_cycles=3.0,
        )
        return Trace("bfs", vcfg, (expand, frontier), (("edges", prob.n_edges),))

    # Vectorized frontier expansion: per block of vl frontier-adjacent edges,
    # gather neighbor ids from ELL adjacency (unit within a node-slice),
    # gather dist of neighbors, compare/min, masked scatter of updates.
    expand = Phase(
        name="edge-relax",
        n_iters=prob.n_edges / vl,
        mem_ops=(
            (MemOp("adj", "unit", vl, I32, adj_fp, reused=False), 1.0),
            (MemOp("dist", "gather", vl, I32, dist_fp, reused=True), 1.0),
            (MemOp("dist-upd", "scatter", vl * 0.2, I32, dist_fp, reused=True), 1.0),
        ),
        valu_ops=4.0,                 # valid-mask, visited-test, min, select
        scalar_cycles=4.0,
        serial_mem_groups=2.0,
    )
    frontier = Phase(
        name="frontier-scan",
        n_iters=prob.bfs_levels * n / vl,
        mem_ops=((MemOp("dist-scan", "unit", vl, I32, dist_fp, reused=True), 1.0),),
        valu_ops=2.0,
        scalar_cycles=4.0,
    )
    return Trace("bfs", vcfg, (expand, frontier), (("edges", prob.n_edges),))


# ---------------------------------------------------------------------------
# PageRank — power iteration of gather-MAC (kernels/pagerank.py)
# ---------------------------------------------------------------------------


def pagerank_trace(prob: GraphProblem, vcfg: VectorConfig) -> Trace:
    vl = vcfg.vl
    n, w = prob.n_nodes, prob.ell_width
    rank_fp = n * F64
    adj_fp = n * w * I32
    iters = prob.pr_iters
    if vcfg.is_scalar:
        spmv = Phase(
            name="pr-gather-mac-scalar",
            n_iters=iters * prob.n_edges,
            mem_ops=(
                (MemOp("adj", "unit", 1, I32, adj_fp, reused=True), 1.0),
                (MemOp("rank", "gather", 1, F64, rank_fp, reused=True), 1.0),
            ),
            scalar_cycles=5.0,
            serial_mem_groups=2.0,
        )
        update = Phase(
            name="pr-update-scalar",
            n_iters=iters * n,
            mem_ops=(
                (MemOp("deg", "unit", 1, F64, n * F64, reused=True), 1.0),
                (MemOp("rank-st", "unit", 1, F64, rank_fp, reused=True), 1.0),
            ),
            scalar_cycles=6.0,
        )
        return Trace("pagerank", vcfg, (spmv, update), (("edges", prob.n_edges),))

    spmv = Phase(
        name="pr-gather-mac",
        n_iters=iters * (n / vl) * w,
        mem_ops=(
            (MemOp("adj", "unit", vl, I32, adj_fp, reused=True), 1.0),
            (MemOp("rank", "gather", vl, F64, rank_fp, reused=True), 1.0),
        ),
        valu_ops=3.0,
        scalar_cycles=4.0,
        serial_mem_groups=2.0,
    )
    update = Phase(
        name="pr-update",
        n_iters=iters * n / vl,
        mem_ops=(
            (MemOp("deg", "unit", vl, F64, n * F64, reused=True), 1.0),
            (MemOp("rank-st", "unit", vl, F64, rank_fp, reused=True), 1.0),
        ),
        valu_ops=3.0,
        scalar_cycles=4.0,
    )
    return Trace("pagerank", vcfg, (spmv, update), (("edges", prob.n_edges),))


# ---------------------------------------------------------------------------
# FFT — Stockham radix-2, split re/im planes (kernels/fft.py)
# ---------------------------------------------------------------------------


def fft_trace(prob: FFTProblem, vcfg: VectorConfig) -> Trace:
    vl = vcfg.vl
    n = prob.n
    plane_fp = 2 * n * F64            # re+im working set (ping or pong)
    stages = prob.stages
    if vcfg.is_scalar:
        # First pass streams the (uncached) input; later stages bounce between
        # the L1/L2-resident ping-pong planes with strided (element-granular)
        # accesses.
        first = Phase(
            name="stage0-scalar",
            n_iters=prob.batch * (n // 2),
            mem_ops=(
                (MemOp("x-stream", "unit", 1, F64, 2 * n * F64, reused=False), 4.0),
                (MemOp("y-store", "scatter", 1, F64, plane_fp, reused=True), 4.0),
            ),
            scalar_cycles=12.0,
        )
        butterfly = Phase(
            name="butterfly-scalar",
            n_iters=prob.batch * (stages - 1) * (n // 2),
            mem_ops=(
                # 2 complex loads + 1 twiddle + 2 complex stores, all f64
                # pairs; strided (Stockham) -> element-granular.
                (MemOp("x-load", "gather", 1, F64, plane_fp, reused=True), 4.0),
                (MemOp("twiddle", "unit", 1, F64, n * F64, reused=True), 2.0),
                (MemOp("y-store", "scatter", 1, F64, plane_fp, reused=True), 4.0),
            ),
            scalar_cycles=12.0,        # complex mul/add in scalar FPU
            serial_mem_groups=1.0,
        )
        return Trace("fft", vcfg, (first, butterfly), (("n", n),))

    # First pass streams the input from memory; remaining stages run out of
    # the L2/VMEM-resident ping-pong planes.
    first = Phase(
        name="stage0-stream",
        n_iters=prob.batch * max(1.0, n / (2 * vl)),
        mem_ops=(
            (MemOp("x-stream", "unit", 2 * vl, F64, 2 * n * F64, reused=False), 2.0),
            (MemOp("y-store", "unit", 2 * vl, F64, plane_fp, reused=True), 2.0),
        ),
        valu_ops=10.0,
        scalar_cycles=6.0,
    )
    rest = Phase(
        name="butterfly",
        n_iters=prob.batch * (stages - 1) * max(1.0, n / (2 * vl)),
        mem_ops=(
            (MemOp("x-load", "unit", 2 * vl, F64, plane_fp, reused=True), 2.0),
            (MemOp("twiddle", "unit", vl, F64, n * F64, reused=True), 2.0),
            (MemOp("y-store", "unit", 2 * vl, F64, plane_fp, reused=True), 2.0),
        ),
        valu_ops=10.0,                # cmul (6) + add/sub (4) on split planes
        scalar_cycles=6.0,
    )
    return Trace("fft", vcfg, (first, rest), (("n", n),))


# ---------------------------------------------------------------------------
# Arrival processes — open-loop load generation for the serving benchmarks
# ---------------------------------------------------------------------------


def poisson_arrivals(rate_rps: float, n: int, seed: int = 0):
    """Arrival offsets (seconds from t=0) of ``n`` requests from a Poisson
    process at ``rate_rps`` — exponential inter-arrival times, the standard
    open-loop load model.  Deterministic per seed, monotone non-decreasing.
    """
    import numpy as np

    if rate_rps <= 0:
        raise ValueError(f"rate_rps must be > 0, got {rate_rps}")
    if n < 1:
        raise ValueError(f"n must be >= 1, got {n}")
    rng = np.random.default_rng(seed)
    return np.cumsum(rng.exponential(1.0 / rate_rps, size=n))


TRACE_BUILDERS = {
    "spmv": lambda vcfg: spmv_trace(PAPER_PROBLEMS["spmv"], vcfg),
    "bfs": lambda vcfg: bfs_trace(PAPER_PROBLEMS["bfs"], vcfg),
    "pagerank": lambda vcfg: pagerank_trace(PAPER_PROBLEMS["pagerank"], vcfg),
    "fft": lambda vcfg: fft_trace(PAPER_PROBLEMS["fft"], vcfg),
}


def build_trace_grid(kernels, vls) -> list[Trace]:
    """Traces for every (kernel, vl) pair, in ``kernel``-major order — the
    flattened leading axis consumed by :func:`repro_torch.core.sdv.evaluate_cube`
    and reshaped back by the campaign runner."""
    return [
        TRACE_BUILDERS[kernel](VectorConfig(vl=vl))
        for kernel in kernels
        for vl in vls
    ]
