"""SDV machine descriptions (paper §2.2/§2.3).

The machine half of ``repro.core.sdv``: :class:`MachineParams`, the TPU
preset of the reference tuner and :func:`h100_machine`, the Hopper
constants.  The fields and defaults are identical to the reference's, so
a machine's cache tag (``service.tunecache.machine_tag``) is the same in
both packages, and a tune the JAX reference cached under a machine is
found by the port under the same key.

The cycle model that scores a transaction trace on a machine is not
ported yet: on an H100 it ranked SELL layouts by pad factor alone (see
:mod:`repro_torch.core.autotune`), and its latencies for the card are
estimates until measured (ROADMAP A14).
"""
from __future__ import annotations

import dataclasses

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

    ESTIMATES, not yet measured on the card (ROADMAP "H100 latency
    measurement"): the DRAM round-trip (``base_mem_latency``), the L1/L2
    hit latencies, the L2 bandwidth and the outstanding-request limits
    (``vector_mlp``, ``mshr``).  No reported time and no tune decision is
    derived from them yet.
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
