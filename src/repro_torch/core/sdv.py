"""SDV machine model — Latency Controller + Bandwidth Limiter (paper §2.2/§2.3).

A copy of ``repro.core.sdv`` plus :func:`h100_machine`, the Hopper
constants.  The FPGA-SDV degrades a *real* memory subsystem: a Latency
Controller stalls every DDR access by a programmable number of cycles, and
a Bandwidth Limiter admits only ``num/den`` requests per cycle window.  The
two knobs are terms of an analytic, pipelined cycle model that consumes the
transaction schedule of each blocked kernel (:mod:`repro_torch.core.traffic`
derives those schedules from the reference's block decomposition).

The model is numpy only and performs the reference's arithmetic in the
reference's order, so a trace scores the same cycles in both packages and
:func:`evaluate_cube` returns a cube equal (``==``) to the reference's.
:class:`MachineParams` has the reference's fields and defaults, so a
machine's cache tag (``service.tunecache.machine_tag``) is the same in
both packages, and a tune the JAX reference cached under a machine is
found by the port under the same key.

The model keeps three effects, which produce the paper's two claims:

* **latency amortization**: the memory round-trip is paid once per *vector
  instruction* (whose in-flight element requests pipeline), and consecutive
  independent instructions overlap up to the machine's memory-level
  parallelism (``vector_mlp`` outstanding instructions; a scalar in-order core
  has ``scalar_mlp = 1``).  Exposed latency therefore scales with
  ``n_instructions / mlp = N / (vl * mlp)`` — the 1/VL law behind Fig 3/4.
* **bandwidth saturation**: transfer time is ``bytes / bytes_per_cycle``; long
  vectors move enough bytes per instruction that transfer (not issue) becomes
  the binding term, so they keep speeding up as the limiter is relaxed — the
  plateau shift of Fig 5.
* **decoupled overlap**: compute and transfer overlap; exposure adds on top.

:func:`h100_machine`'s latencies and concurrency limits are estimates until
measured on the card (ROADMAP A14), so cycles modeled for it are estimates
too; the study phase of ``chip_smoke.py`` prints them beside the card's
timings.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Sequence

import numpy as np

from repro_torch.core.vconfig import VectorConfig

# ---------------------------------------------------------------------------
# Machine description
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MachineParams:
    """Micro-architectural constants of the modeled machine.

    Defaults describe the FPGA-SDV of the paper: Atrevido + Vitruvius (8
    lanes), 50 MHz emulated clock, ~50-cycle minimum DDR latency, 64 B/cycle
    peak memory bandwidth, 2x2 L2HN mesh (4 x 256 KiB shared L2).
    """

    name: str = "fpga-sdv"
    freq_mhz: float = 50.0
    lanes: int = 8
    line_bytes: int = 64

    # Memory subsystem.
    base_mem_latency: int = 50        # minimum DDR round-trip (paper §2.2)
    l1_latency: int = 3               # core-private L1d hit
    l1_bytes: int = 32 * 1024
    l2_latency: int = 12              # L2HN hit latency via NoC
    l2_bytes: int = 4 * 256 * 1024    # 2x2 L2HN mesh
    l2_bw_bytes_per_cycle: float = 64.0
    peak_bw_bytes_per_cycle: float = 64.0

    # Memory-level parallelism: the decoupled Vitruvius VPU keeps
    # ``vector_mlp`` memory *instructions* in flight; each contributes its
    # line/element transactions to the outstanding-request pool, bounded by
    # ``mshr`` miss-status registers.  The in-order scalar pipeline blocks on
    # each miss (scalar_mlp = 1).
    vector_mlp: int = 6
    scalar_mlp: int = 1
    mshr: int = 144

    # Address-generation throughput for indexed (gather/scatter) accesses,
    # element requests issued per cycle (one per lane).
    gather_ports: int = 8

    # Longest vector the ISA exposes, in f64 elements (0 = unbounded).  The
    # analytic model happily evaluates any requested VL — this field exists
    # so short-vector presets (SVE-512 / AVX-512) can declare which slice of
    # a campaign's VL axis the real machine could execute, and claim checks
    # / the serving tuner restrict themselves to it.
    max_vl: int = 0

    # --- knobs: the two hardware modules of the paper -------------------
    extra_latency: int = 0            # Latency Controller (cycles added)
    bw_limit_bytes_per_cycle: float = 64.0  # Bandwidth Limiter (B/cycle)

    def supports_vl(self, vl: int) -> bool:
        """Can the real machine execute this VL (scalar always counts)?"""
        return self.max_vl <= 0 or vl <= self.max_vl

    # -- derived ----------------------------------------------------------
    @property
    def mem_latency(self) -> int:
        return self.base_mem_latency + self.extra_latency

    @property
    def eff_bw(self) -> float:
        return min(self.peak_bw_bytes_per_cycle, self.bw_limit_bytes_per_cycle)

    # -- the two software-configurable modules ---------------------------
    def with_latency(self, extra_cycles: int) -> "MachineParams":
        """Latency Controller write: add ``extra_cycles`` to every DDR access."""
        return dataclasses.replace(self, extra_latency=int(extra_cycles))

    def with_bandwidth(self, bytes_per_cycle: float) -> "MachineParams":
        """Bandwidth Limiter write: throttle DDR to ``bytes_per_cycle``."""
        return dataclasses.replace(self, bw_limit_bytes_per_cycle=float(bytes_per_cycle))

    def with_bandwidth_fraction(self, num: int, den: int) -> "MachineParams":
        """The paper's num/den window interface (§2.3): e.g. 1/3 = 33% peak."""
        return self.with_bandwidth(self.peak_bw_bytes_per_cycle * num / den)


def fpga_sdv_machine(**kw) -> MachineParams:
    """The paper's experimental setup."""
    return MachineParams(**kw)


def tpu_v5e_machine(**kw) -> MachineParams:
    """TPU v5e single-core view of the same model: the reference tuner's
    default machine, kept so a tune the JAX reference cached under it can
    be keyed (and reused) by the port.

    940 MHz core clock; 819 GB/s HBM => ~871 B/cycle; ~550-cycle HBM
    round-trip; VMEM (128 MiB/16 = ~16 MiB usable per core-slice) plays the
    role of the L2; VPU is 8x128 lanes.
    """
    defaults = dict(
        name="tpu-v5e",
        freq_mhz=940.0,
        lanes=8 * 128,
        line_bytes=512,               # HBM transaction granule
        base_mem_latency=550,
        l2_latency=30,                # VMEM-resident access
        l2_bytes=16 * 1024 * 1024,    # VMEM
        l2_bw_bytes_per_cycle=8 * 128 * 4,
        peak_bw_bytes_per_cycle=871.0,
        bw_limit_bytes_per_cycle=871.0,
        vector_mlp=16,                # outstanding DMA descriptors
        scalar_mlp=1,
        mshr=512,
        gather_ports=8,
    )
    defaults.update(kw)
    return MachineParams(**defaults)


def h100_machine(**kw) -> MachineParams:
    """NVIDIA H100 SXM view of the same model: the machine the port's
    tunes are keyed under (:func:`repro_torch.kernels.ops.pack_tuned`,
    :class:`repro_torch.service.registry.KernelRegistry`).

    Sourced constants (NVIDIA H100 Tensor Core GPU data sheet and the
    Hopper architecture white paper): 1,980 MHz maximum SM boost clock;
    3.35 TB/s HBM3 => 3.35e12 / 1.98e9 ~ 1,692 B/cycle; 50 MB L2 with
    128 B cache lines; 256 KB of combined L1/shared memory per SM; a warp
    of 32 threads is the lane group one SELL slice column maps onto.

    ESTIMATES, not yet measured on the card (ROADMAP A14): the DRAM
    round-trip (``base_mem_latency``), the L1/L2 hit latencies, the L2
    bandwidth and the outstanding-request limits (``vector_mlp``,
    ``mshr``).  Cycles modeled with them are estimates: the study phase of
    ``chip_smoke.py`` prints them beside measured kernel times.  Only a
    campaign warm start (``TuneCache.warm_from_sweeps``) derives anything
    from them: a VL hint that narrows the SELL tuner's candidate C, which
    it still ranks by measured pad factor.
    """
    defaults = dict(
        name="h100-sxm",
        freq_mhz=1980.0,              # data sheet: max SM boost clock
        lanes=32,                     # one warp
        line_bytes=128,               # L2 cache line
        base_mem_latency=600,         # estimate: HBM round-trip, cycles
        l1_latency=35,                # estimate
        l1_bytes=256 * 1024,          # data sheet: L1/shared per SM
        l2_latency=260,               # estimate
        l2_bytes=50 * 1000 * 1000,    # data sheet: 50 MB L2
        l2_bw_bytes_per_cycle=2 * 1692.0,   # estimate: ~2x HBM rate
        peak_bw_bytes_per_cycle=1692.0,     # data sheet: 3.35 TB/s
        bw_limit_bytes_per_cycle=1692.0,
        vector_mlp=64,                # estimate: warps in flight per SM
        scalar_mlp=1,
        mshr=4096,                    # estimate: outstanding L2 misses
        gather_ports=32,              # one address per warp lane
    )
    defaults.update(kw)
    return MachineParams(**defaults)


# ---------------------------------------------------------------------------
# Transaction traces
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class MemOp:
    """One class of memory access executed per loop iteration.

    Attributes:
      name: label for breakdowns.
      pattern: 'unit' (unit-stride burst), 'gather' or 'scatter' (indexed).
      elems: elements touched per instruction (<= vl; the vsetvl tail makes
        the last instruction shorter — callers pass the average).
      elem_bytes: bytes per element.
      footprint_bytes: size of the underlying data structure, used to decide
        L2 residency.
      reused: True if the structure is re-walked across iterations (candidate
        for L2 hits); False for single-pass streams (compulsory misses).
    """

    name: str
    pattern: str
    elems: float
    elem_bytes: int = 8
    footprint_bytes: int = 0
    reused: bool = False

    def transactions(self, line_bytes: int) -> float:
        """Memory transactions issued by ONE instruction of this op.

        Unit-stride bursts are line-granular and may be fractional (< 1 line
        per instruction amortizes consecutive scalar accesses to one line);
        indexed accesses issue one transaction per element.
        """
        if self.pattern == "unit":
            return self.elems * self.elem_bytes / line_bytes
        return max(1.0, self.elems)  # element-granular requests

    def bytes_moved(self) -> float:
        return self.elems * self.elem_bytes


@dataclasses.dataclass(frozen=True)
class Phase:
    """A loop nest: ``n_iters`` iterations, each issuing the listed ops.

    ``mem_ops`` maps op -> instructions per iteration.  ``valu_ops`` counts
    vector arithmetic instructions per iteration (each occupies
    ceil(elems/lanes) cycles); ``scalar_cycles`` is fixed scalar/control
    overhead per iteration; ``serial_mem_groups`` is the number of
    *dependent* memory instruction groups on the critical path (a gather that
    needs a previously loaded index vector cannot overlap with it).
    """

    name: str
    n_iters: float
    mem_ops: tuple[tuple[MemOp, float], ...]
    valu_ops: float = 0.0
    valu_elems: float | None = None   # elements per VALU op (default: vl)
    scalar_cycles: float = 0.0
    serial_mem_groups: float = 1.0


@dataclasses.dataclass(frozen=True)
class Trace:
    """Full transaction schedule of one kernel run at one vector length."""

    kernel: str
    vcfg: VectorConfig
    phases: tuple[Phase, ...]
    meta: tuple[tuple[str, float], ...] = ()


# ---------------------------------------------------------------------------
# The cycle model
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class PhaseCoeffs:
    """Knob-independent terms of one phase on one machine.

    Everything here depends only on the trace and the machine's *static*
    parameters (cache sizes, line size, MLP, ports); the two SDV knobs —
    added latency and the bandwidth limit — enter later, either as scalars
    in :meth:`SDVMachine.run` or as whole array axes in
    :func:`evaluate_cube`.  Keeping the split exact is what lets the
    vectorized cube agree with the per-point model bit-for-bit.
    """

    n_iters: float
    missing: float           # DRAM transactions / iteration
    dram_bytes: float        # DRAM bytes / iteration
    l2_cycles: float         # l2_bytes / l2 bandwidth (fixed-path transfer)
    issue: float             # gather/scatter address-generation cycles
    dep_hit_lat: float       # serialized hit latency (scalar dependent loads)
    hit_extra: float         # vector-path cache-pipeline drain (0 if no hits)
    compute: float           # VALU occupancy + scalar overhead / iteration
    outstanding: float       # Little's-law concurrency cap
    l2_bytes: float
    mem_instructions: float


@dataclasses.dataclass
class PhaseResult:
    name: str
    cycles: float
    transfer_cycles: float
    compute_cycles: float
    exposure_cycles: float
    dram_bytes: float
    l2_bytes: float
    mem_instructions: float


@dataclasses.dataclass
class RunResult:
    kernel: str
    vl: int
    cycles: float
    phases: list[PhaseResult]

    @property
    def seconds(self) -> float:  # pragma: no cover - convenience
        return self.cycles  # caller divides by freq if wall time is wanted

    def breakdown(self) -> dict[str, float]:
        return {
            "transfer": sum(p.transfer_cycles for p in self.phases),
            "compute": sum(p.compute_cycles for p in self.phases),
            "exposure": sum(p.exposure_cycles for p in self.phases),
        }

    @property
    def dram_bytes(self) -> float:
        return sum(p.dram_bytes for p in self.phases)

    @property
    def mem_instructions(self) -> float:
        return sum(p.mem_instructions for p in self.phases)


class SDVMachine:
    """Executes a :class:`Trace` on a :class:`MachineParams` configuration."""

    def __init__(self, params: MachineParams):
        self.params = params

    # -- per-op helpers ---------------------------------------------------
    def _miss_rate(self, op: MemOp) -> float:
        """Fraction of transactions served by DRAM rather than the L2."""
        p = self.params
        if op.footprint_bytes <= 0:
            return 1.0
        if not op.reused:
            return 1.0  # single-pass stream: compulsory misses
        # Steady-state random access into a structure of given footprint:
        # hit probability = fraction of it resident in L2.
        resident = min(1.0, p.l2_bytes / max(1, op.footprint_bytes))
        return 1.0 - resident

    # -- phase model ------------------------------------------------------
    #
    # Little's law with two occupancy caps.  Per iteration we count, over all
    # memory instructions: DRAM transactions ("missing"), L2 transactions
    # ("hitting"), bytes on each path, and gather/scatter issue slots.  A
    # decoupled vector engine sustains
    #     outstanding = min(vector_mlp * transactions_per_instruction, mshr)
    # concurrent transactions, so the latency-bound throughput term is
    #     missing * mem_latency / outstanding.
    # Longer vectors raise transactions_per_instruction and therefore raise
    # ``outstanding`` until the MSHR cap -- this IS the paper's latency-
    # tolerance mechanism.  The iteration time is the max of the bandwidth
    # term, the latency term and the compute term (decoupled overlap); an
    # in-order scalar core instead serializes compute + transfer + latency.
    def phase_coeffs(self, phase: Phase, vcfg: VectorConfig, mlp: float) -> PhaseCoeffs:
        """Fold one phase into its knob-independent :class:`PhaseCoeffs`."""
        p = self.params
        dram_bytes = 0.0
        l2_bytes = 0.0
        missing = 0.0            # DRAM transactions / iteration
        hitting = 0.0            # L2 transactions / iteration
        dep_hit_lat = 0.0        # serial L2 latency (scalar dependent loads)
        n_instr = 0.0
        trans_total = 0.0
        issue = 0.0
        hit_drain = 0.0
        for op, count in phase.mem_ops:
            miss = self._miss_rate(op)
            trans = op.transactions(p.line_bytes)
            # latency of a hit depends on where the structure fits
            hit_lat = p.l1_latency if op.footprint_bytes <= p.l1_bytes else p.l2_latency
            missing += count * trans * miss
            hitting += count * trans * (1.0 - miss)
            if miss < 1.0:
                hit_drain = max(hit_drain, float(hit_lat))
            if op.pattern == "unit":
                dram_bytes += count * op.bytes_moved() * miss
            else:
                # critical-word transfer for indexed misses
                dram_bytes += count * trans * miss * op.elem_bytes
                issue += count * op.elems / p.gather_ports
                # dependent (pointer-chasing) hits serialize on in-order cores
                dep_hit_lat += count * (1.0 - miss) * hit_lat
            l2_bytes += count * op.bytes_moved() * (1.0 - miss)
            n_instr += count
            trans_total += count * trans
        valu_elems = phase.valu_elems if phase.valu_elems is not None else vcfg.vl
        compute = (
            phase.valu_ops * max(1.0, math.ceil(valu_elems / p.lanes))
            + phase.scalar_cycles
        )
        trans_per_instr = trans_total / max(n_instr, 1.0)
        outstanding = max(1.0, min(mlp * trans_per_instr, float(p.mshr)))
        return PhaseCoeffs(
            n_iters=phase.n_iters,
            missing=missing,
            dram_bytes=dram_bytes,
            l2_cycles=l2_bytes / p.l2_bw_bytes_per_cycle,
            issue=issue,
            dep_hit_lat=dep_hit_lat,
            hit_extra=hit_drain if hitting > 0 else 0.0,
            compute=compute,
            outstanding=outstanding,
            l2_bytes=l2_bytes,
            mem_instructions=n_instr,
        )

    def _run_phase(self, phase: Phase, vcfg: VectorConfig, mlp: float) -> PhaseResult:
        p = self.params
        c = self.phase_coeffs(phase, vcfg, mlp)
        transfer = c.dram_bytes / p.eff_bw + c.l2_cycles + c.issue
        if vcfg.is_scalar:
            # In-order: every miss and every dependent hit is exposed.  The
            # line transfer of a blocking miss happens *within* the exposed
            # round-trip, so bandwidth only binds when a line takes longer to
            # stream than the round-trip itself: max(), not sum -- this is
            # why a scalar core cannot exploit more than 1-2 B/cycle (Fig 5).
            latency_time = c.missing * p.mem_latency + c.dep_hit_lat
            cycles_per_iter = c.compute + max(transfer, latency_time)
            exposure = latency_time
        else:
            # cache-pipeline drain (hit_extra) rides on top of the
            # Little's-law exposed-miss term
            latency_time = c.missing * p.mem_latency / c.outstanding + c.hit_extra
            cycles_per_iter = max(transfer, latency_time, c.compute)
            exposure = latency_time
        total = c.n_iters * cycles_per_iter + p.mem_latency  # pipeline drain
        return PhaseResult(
            name=phase.name,
            cycles=total,
            transfer_cycles=c.n_iters * transfer,
            compute_cycles=c.n_iters * c.compute,
            exposure_cycles=c.n_iters * exposure,
            dram_bytes=c.n_iters * c.dram_bytes,
            l2_bytes=c.n_iters * c.l2_bytes,
            mem_instructions=c.n_iters * c.mem_instructions,
        )

    def run(self, trace: Trace) -> RunResult:
        mlp = float(self.params.scalar_mlp if trace.vcfg.is_scalar else self.params.vector_mlp)
        phases = [self._run_phase(ph, trace.vcfg, mlp) for ph in trace.phases]
        return RunResult(
            kernel=trace.kernel,
            vl=trace.vcfg.vl,
            cycles=sum(p.cycles for p in phases),
            phases=phases,
        )


# ---------------------------------------------------------------------------
# Vectorized cube evaluation — the whole knob grid in one broadcast
# ---------------------------------------------------------------------------


def evaluate_cube(
    traces: Sequence[Trace],
    machine: MachineParams,
    extra_latencies: Sequence[int],
    bw_limits: Sequence[float],
) -> np.ndarray:
    """Cycles for every (trace, extra_latency, bw_limit) point at once.

    Replaces the per-point ``SDVMachine(machine.with_latency(l)
    .with_bandwidth(b)).run(trace)`` triple loop with a single numpy
    broadcast: the knob-independent :class:`PhaseCoeffs` of each trace are
    stacked into ``(trace, phase)`` arrays and the two knobs become trailing
    axes, so an arbitrarily large campaign grid costs one array expression
    instead of thousands of Python-level model runs.

    The arithmetic mirrors :meth:`SDVMachine._run_phase` operation for
    operation (same order, same float64 terms), so each cube cell equals the
    per-point result *exactly* — tests assert ``==``, not ``approx``.

    Returns an array of shape ``(len(traces), len(extra_latencies),
    len(bw_limits))``.
    """
    if not traces:
        return np.zeros((0, len(extra_latencies), len(bw_limits)))
    p = machine
    model = SDVMachine(p)
    n_t = len(traces)
    n_p = max(len(t.phases) for t in traces)

    (n_iters, missing, dram_bytes, l2_cycles, issue, dep_hit_lat, hit_extra,
     compute) = (np.zeros((n_t, n_p)) for _ in range(8))
    outstanding = np.ones((n_t, n_p))  # pad-safe divisor
    valid = np.zeros((n_t, n_p), dtype=bool)
    is_scalar = np.zeros(n_t, dtype=bool)
    for i, trace in enumerate(traces):
        is_scalar[i] = trace.vcfg.is_scalar
        mlp = float(p.scalar_mlp if trace.vcfg.is_scalar else p.vector_mlp)
        for j, phase in enumerate(trace.phases):
            c = model.phase_coeffs(phase, trace.vcfg, mlp)
            n_iters[i, j] = c.n_iters
            missing[i, j] = c.missing
            dram_bytes[i, j] = c.dram_bytes
            l2_cycles[i, j] = c.l2_cycles
            issue[i, j] = c.issue
            dep_hit_lat[i, j] = c.dep_hit_lat
            hit_extra[i, j] = c.hit_extra
            compute[i, j] = c.compute
            outstanding[i, j] = c.outstanding
            valid[i, j] = True

    # knob axes: (trace, phase, latency, bandwidth)
    lat = np.asarray(extra_latencies, dtype=np.float64).reshape(1, -1, 1)
    bw = np.asarray(bw_limits, dtype=np.float64).reshape(1, 1, -1)
    mem_latency = float(p.base_mem_latency) + lat
    eff_bw = np.minimum(float(p.peak_bw_bytes_per_cycle), bw)

    scal = is_scalar[:, None, None]
    cycles = np.zeros((n_t, len(extra_latencies), len(bw_limits)))
    for j in range(n_p):
        col = (slice(None), j, None, None)    # (T,) phase column -> (T, 1, 1)
        transfer = dram_bytes[col] / eff_bw + l2_cycles[col] + issue[col]
        lt_scalar = missing[col] * mem_latency + dep_hit_lat[col]
        per_scalar = compute[col] + np.maximum(transfer, lt_scalar)
        lt_vector = missing[col] * mem_latency / outstanding[col] + hit_extra[col]
        per_vector = np.maximum(np.maximum(transfer, lt_vector), compute[col])
        per_iter = np.where(scal, per_scalar, per_vector)
        total = n_iters[col] * per_iter + mem_latency
        # accumulate sequentially so the phase sum matches the per-point
        # Python ``sum`` bit-for-bit (padded phases contribute exact zeros)
        cycles += np.where(valid[col], total, 0.0)
    return cycles


# ---------------------------------------------------------------------------
# Convenience sweep entry points (the experiment knobs of §4)
# ---------------------------------------------------------------------------

PAPER_LATENCIES: tuple[int, ...] = (0, 16, 32, 64, 128, 256, 512, 1024)
PAPER_BANDWIDTHS: tuple[int, ...] = (1, 2, 4, 8, 16, 32, 64)


def run_latency_sweep(
    base: MachineParams,
    trace: Trace,
    latencies: Sequence[int] = PAPER_LATENCIES,
) -> dict[int, RunResult]:
    return {lat: SDVMachine(base.with_latency(lat)).run(trace) for lat in latencies}


def run_bandwidth_sweep(
    base: MachineParams,
    trace: Trace,
    bandwidths: Sequence[int] = PAPER_BANDWIDTHS,
) -> dict[int, RunResult]:
    return {bw: SDVMachine(base.with_bandwidth(bw)).run(trace) for bw in bandwidths}
